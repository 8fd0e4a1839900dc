"""Serving parity of the port (repro_torch) with the JAX package, dense family.

Weights are made once by the JAX package and moved with
``convert.params_from_jax`` (jax.random cannot be reproduced in torch);
prompts come from numpy seeds. JAX runs on the CPU, the port with
device="cpu", where its full-H attention takes K1's plain version.

Tolerances. f32: logits and cache atol = rtol = 1e-4, greedy tokens
equal. bf16: the reference rounds the attention scores to bf16 before
the softmax and the port does not (see tests/test_torch_attention.py),
and 4 layers of bf16 activations compound that. With this test's inputs
over prompt seeds 0-4, the largest differences were 1.8e-2 in the
prefill logits (|logit| < 0.94), 2.0e-2 in the decode logits, and
6.4e-2 in the cached k/v (|k|, |v| < 3.8, about 4 bf16 ulps), so the
bf16 tolerances are 4e-2 on logits and 1.25e-1 on the cache, absolute.
Those runs also chose one greedy token differently in 4 of 5 seeds (a
near-tie), so in bf16 the port's decode is fed the reference's greedy
tokens (teacher forcing); the tokens themselves are held equal in f32.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
from repro_torch.runtime.serve import build_decode_step, build_prefill_step  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = 1e-4
BF16_LOGIT_TOL = 4e-2
BF16_CACHE_TOL = 1.25e-1


def _models(cfg_name, dtype, *, n_layers=None, vocab_size=None):
    """(JAX model, JAX params, port model, port params) sharing weights."""
    jc, tc = jax_config(cfg_name).reduced(), get_config(cfg_name).reduced()
    if n_layers is not None:       # full width, cut in depth and vocab
        jc = dataclasses.replace(jax_config(cfg_name), n_layers=n_layers,
                                 vocab_size=vocab_size)
        tc = dataclasses.replace(get_config(cfg_name), n_layers=n_layers,
                                 vocab_size=vocab_size)
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


def _jax_greedy(jm, jp, prompts, steps):
    """The JAX serving loop of examples/serve_batch.py: prefill, then greedy decode."""
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    pad = ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))
    cache = dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))
    decode = jax.jit(jm.decode)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, step_logits = [tok], []
    for _ in range(steps):
        lg, cache = decode(jp, cache, {"tokens": tok})
        step_logits.append(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(tok)
    return np.concatenate([np.asarray(t) for t in toks], axis=1), step_logits


def _grow(cache, extra):
    pad = (0, 0, 0, 0, 0, extra)
    return dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                v=torch.nn.functional.pad(cache["v"], pad))


# ---------------------------------------------------------------------------
# reduced qwen2-0.5b: prefill logits + cache, greedy decode, f32 and bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_prefill_and_greedy_decode(dtype):
    jm, jp, tm, tp = _models("qwen2-0.5b", dtype)
    prompts = _tokens(tm.cfg, 2, 24, seed=1)
    steps = 8
    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    cache_tol = F32_TOL if dtype == "float32" else BF16_CACHE_TOL

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    assert tl.shape == (2, 1, tm.cfg.vocab_padded) and tl.dtype == TORCH_DTYPE[dtype]
    assert tc["pos"] == int(jc["pos"]) == 24
    assert tc["k"].shape == jc["k"].shape == (4, 2, 24, 2, 32)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=F32_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), atol=cache_tol,
                                   rtol=F32_TOL)

    jtoks, jlogits = _jax_greedy(jm, jp, prompts, steps)
    cache = _grow(tc, steps)
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
    if dtype == "float32":
        np.testing.assert_array_equal(torch.cat(ttoks, dim=1).numpy(), jtoks)


def test_dense_family_switches_f32():
    """The dense-family switches qwen2 leaves off (gemma's scaled
    embeddings, logit soft cap, GeGLU, and an untied head), on the
    reduced config: prefill and one decode step against JAX."""
    switches = dict(scale_embeddings=True, logit_softcap=30.0, gelu_mlp=True,
                    tie_embeddings=False, qkv_bias=False)
    jc = dataclasses.replace(jax_config("qwen2-0.5b").reduced(), **switches)
    tc = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **switches)
    jm = jax_build(jc, JaxRunConfig(param_dtype="float32", compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build(tc, RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32,
                             device="cpu"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert "head" in tp and "bq" not in tp["blocks"]["attn"]
    prompts = _tokens(tc, 2, 12, seed=8)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad), v=jnp.pad(jcache["v"], pad))
    nxt = np.full((2, 1), 3, np.int32)
    jd, _ = jm.decode(jp, jcache, {"tokens": jnp.asarray(nxt)})
    td, _ = tm.decode(tp, _grow(tcache, 1), {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(_np(td), _np(jd), atol=F32_TOL, rtol=F32_TOL)


def test_full_width_two_layers_f32():
    """qwen2-0.5b at its published width (14 heads, 2 KV heads, head_dim 64,
    d_ff 4864), cut to 2 layers and a 512-token vocab."""
    jm, jp, tm, tp = _models("qwen2-0.5b", "float32", n_layers=2, vocab_size=512)
    assert (tm.cfg.d_model, tm.cfg.n_heads, tm.cfg.n_kv_heads,
            tm.cfg.resolved_head_dim) == (896, 14, 2, 64)
    prompts = _tokens(tm.cfg, 2, 16, seed=2)
    jl, _, _ = jm.apply(jp, {"tokens": jnp.asarray(prompts)})
    tl, _, _ = tm.apply(tp, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)
    jtoks, jlogits = _jax_greedy(jm, jp, prompts, 3)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prompts)})
    cache = _grow(cache, 3)
    tok = tl[:, -1:].argmax(dim=-1)
    for t in range(3):
        lg, cache = tm.decode(tp, cache, {"tokens": tok})
        np.testing.assert_allclose(_np(lg), _np(jlogits[t]), atol=F32_TOL, rtol=F32_TOL)
        tok = lg.argmax(dim=-1)
        assert np.array_equal(tok.numpy(), jtoks[:, t + 1:t + 2])


def test_decode_continues_a_jax_cache():
    """A cache made by the JAX prefill, moved with cache_from_jax, decodes
    to the JAX logits."""
    jm, jp, tm, tp = _models("qwen2-0.5b", "float32")
    prompts = _tokens(tm.cfg, 2, 10, seed=3)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    jc = dict(jc, k=jnp.pad(jc["k"], pad), v=jnp.pad(jc["v"], pad))
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["pos"] == 10
    nxt = np.full((2, 1), 7, np.int32)
    jl, _ = jm.decode(jp, jc, {"tokens": jnp.asarray(nxt)})
    tl, _ = tm.decode(tp, tc, {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(_np(tl), _np(jl), atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------------------------------
# cache correctness of the port itself (tests/test_serving.py, qwen2 only)
# ---------------------------------------------------------------------------
def _port_model():
    cfg = get_config("qwen2-0.5b").reduced()
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
    cache = _grow(cache, S - k)
    outs = []
    for t in range(k, S):
        logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(logits)
    err = (torch.cat(outs, dim=1) - full[:, k:]).abs().max()
    assert float(err) < 2e-3, float(err)


# ---------------------------------------------------------------------------
# runtime.serve, scope of the slice
# ---------------------------------------------------------------------------
def test_serve_steps_match_the_model():
    cfg = get_config("qwen2-0.5b").reduced()
    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device="cpu")
    prefill, params_meta, batch_meta, sh, model = build_prefill_step(cfg, None, B=2, S=8, rc=rc)
    assert sh is None and batch_meta["tokens"].shape == (2, 8)
    assert batch_meta["tokens"].device.type == "meta"
    assert params_meta["blocks"]["attn"]["wq"].shape == (4, 128, 128)
    decode, _, cache_meta, dbatch, _, _ = build_decode_step(
        cfg, ShapeConfig("d", "decode", 12, 2), None, rc=rc)
    assert cache_meta["k"].shape == (4, 2, 12, 2, 32) and cache_meta["pos"] == 0
    assert dbatch["tokens"].shape == (2, 1)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(cfg, 2, 8, seed=6).astype(np.int64))
    logits, cache = prefill(params, {"tokens": tokens})
    ref_logits, _, _ = model.apply(params, {"tokens": tokens})
    torch.testing.assert_close(logits, ref_logits[:, -1:])
    cache = _grow(cache, 4)
    before = cache["k"]
    _, cache = decode(params, cache, {"tokens": logits.argmax(-1)})
    assert cache["k"] is before and cache["pos"] == 9   # written in place


def test_out_of_slice_paths_raise():
    cfg = get_config("qwen2-0.5b").reduced()
    rc = RunConfig(device="cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        build_prefill_step(cfg, object(), B=1, S=4, rc=rc)
    with pytest.raises(NotImplementedError, match="parallel"):
        build_decode_step(cfg, ShapeConfig("d", "decode", 4, 1), object(), rc=rc)
    for family, name in (("moe", "MoE"), ("vlm", "VLM")):
        model = build(dataclasses.replace(cfg, family=family), rc)
        with pytest.raises(NotImplementedError, match=name):
            model.init(torch.Generator().manual_seed(0))


def test_launch_counter_counts_only_the_card():
    model, params = _port_model()
    before = ops.attention.launches
    tokens = torch.from_numpy(_tokens(model.cfg, 1, 8, seed=7).astype(np.int64))
    model.prefill(params, {"tokens": tokens})
    assert ops.attention.launches == before


# ---------------------------------------------------------------------------
# import hygiene and chip_smoke.py
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 64, mods\n"
        "named = {'repro_torch.optim.adamw', 'repro_torch.parallel.compression',\n"
        "         'repro_torch.runtime.train', 'repro_torch.data.pipeline',\n"
        "         'repro_torch.checkpoint.checkpointer', 'repro_torch.tree',\n"
        "         'repro_torch.configs.zamba2_1p2b', 'repro_torch.configs.gemma_7b',\n"
        "         'repro_torch.configs.workflows', 'repro_torch.examples',\n"
        "         'repro_torch.examples.serve_batch', 'repro_torch.examples.workflow_train',\n"
        "         'repro_torch.core', 'repro_torch.core.policy'}\n"
        "named |= {f'repro_torch.core.{m}' for m in (\n"
        "    'autoscaler', 'baselines', 'calibration', 'chaos', 'cluster', 'dag',\n"
        "    'descheduler', 'engine', 'events', 'gateway', 'informer', 'injector',\n"
        "    'metrics', 'payloads', 'resources', 'runner', 'schedulers', 'shuffle',\n"
        "    'sim', 'stats', 'volumes', 'policy.filters', 'policy.ordering',\n"
        "    'policy.pipeline', 'policy.preemption', 'policy.reservations')}\n"
        "assert named <= set(mods), sorted(named - set(mods))\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("on a card the script runs in full; see chip_smoke.py")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                             text=True, timeout=300, cwd=str(cwd))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.fixture
def chip_smoke():
    """The repo-root script, imported as a module (its main() is not run)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_phases_rehearse_on_cpu(chip_smoke):
    cfg = get_config("qwen2-0.5b").reduced()
    res = chip_smoke.serve(cfg, device="cpu", batch=2, prompt_len=16, decode_steps=3)
    assert res["tokens"].shape == (2, 4)
    no_card = {"attention": 0, "ssd": 0}
    assert res["prefill_launches"] == res["request_launches"] == no_card
    errs = chip_smoke.consistency(cfg, device="cpu", prefill_batch=2, prefill_len=16,
                                  batch=2, seq_len=12, split=5)
    assert errs["prefill_kernels_vs_plain"] == 0.0
    assert errs["prefill_decode_vs_forward"] < chip_smoke.DECODE_TOL


def test_k1_bound_at_the_serving_shape(chip_smoke):
    # K-head k/v: q and o 2 * 7.34 MB, k and v 2 * 1.05 MB (K = 2), 16.8 MB
    ms, by = chip_smoke.attention_bound(8, 512, 512, 14, 2, 64, torch.bfloat16, True)
    assert by == "bytes"
    assert abs(ms - (2 * 8 * 512 * 14 + 2 * 8 * 512 * 2) * 64 * 2 / 3.35e12 * 1e3) < 1e-12
    full_h, _ = chip_smoke.attention_bound(8, 512, 512, 14, 14, 64, torch.bfloat16, True)
    assert abs(full_h - 4 * 8 * 512 * 14 * 64 * 2 / 3.35e12 * 1e3) < 1e-12   # 29.4 MB
    ms32, by32 = chip_smoke.attention_bound(8, 512, 512, 14, 2, 64, torch.float32, True)
    assert by32 == "operations"     # 3.77 GFLOP of f32 at 67 TFLOP/s
    assert abs(ms32 - 4 * 8 * 14 * 64 * (512 * 513 // 2) / 67e12 * 1e3) < 1e-12
