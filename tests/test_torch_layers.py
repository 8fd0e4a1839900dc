"""Parity of the port's configs and layers (repro_torch) with the JAX package.

Inputs are made with numpy from a seed and handed to both; JAX runs on
the CPU and the port with device="cpu". f32 agrees to rounding (1e-5 or
tighter); bf16 to one or two bf16 ulps of the output (2e-2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jcfg  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a jnp array and a CPU tensor of ``dtype``."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(TORCH_DTYPE[dtype])


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs: the port keeps its own copy; it must equal the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b", "zamba2-1.2b", "gemma-7b",
                                  "qwen2-1.5b", "deepseek-67b", "qwen2-moe-a2.7b",
                                  "llama4-scout-17b-a16e", "musicgen-medium",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced, arch):
    a, b = jcfg.get_config(arch), tcfg.get_config(arch)
    if reduced:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.vocab_padded, a.resolved_head_dim, a.param_count()) == \
        (b.vocab_padded, b.resolved_head_dim, b.param_count())


def test_shapes_and_registry():
    assert {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
    assert tcfg.list_configs() == jcfg.list_configs() == [
        "deepseek-67b", "gemma-7b", "llama-3.2-vision-11b", "llama4-scout-17b-a16e",
        "mamba2-2.7b", "musicgen-medium", "qwen2-0.5b", "qwen2-1.5b", "qwen2-moe-a2.7b",
        "zamba2-1.2b"]
    cfg = tcfg.get_config("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_padded) == \
        (24, 896, 14, 2, 64, 4864, 152064)
    cfg = tcfg.get_config("mamba2-2.7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width, cfg.ssm_chunk,
            cfg.vocab_padded, cfg.tie_embeddings) == \
        ("ssm", 64, 2560, 5120, 80, 64, 128, 4, 128, 50432, False)
    cfg = tcfg.get_config("zamba2-1.2b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.ssm_n_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.attn_every, cfg.vocab_padded) == \
        ("hybrid", 38, 2048, 32, 32, 64, 8192, 64, 64, 64, 6, 32000)
    cfg = tcfg.get_config("gemma-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_padded, cfg.gelu_mlp, cfg.scale_embeddings,
            cfg.tie_embeddings) == (28, 3072, 16, 16, 256, 24576, 256000, True, True, True)
    cfg = tcfg.get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_padded, cfg.qkv_bias, cfg.tie_embeddings) == \
        (28, 1536, 12, 2, 128, 8960, 152064, True, True)
    cfg = tcfg.get_config("deepseek-67b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_padded, cfg.tie_embeddings) == \
        (95, 8192, 64, 8, 128, 22016, 102400, False)
    cfg = tcfg.get_config("qwen2-moe-a2.7b")      # registered with its published shape
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.n_experts, cfg.n_experts_padded, cfg.top_k,
            cfg.expert_d_ff, cfg.shared_expert_d_ff, cfg.capacity_factor, cfg.qkv_bias,
            cfg.vocab_padded) == \
        ("moe", 24, 2048, 16, 16, 128, 60, 64, 4, 1408, 5632, 1.25, True, 152064)
    cfg = tcfg.get_config("musicgen-medium")
    assert (cfg.family, cfg.frontend, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_padded) == \
        ("audio", "audio", 48, 1536, 24, 24, 64, 6144, 2048)
    cfg = tcfg.get_config("llama-3.2-vision-11b")
    assert (cfg.family, cfg.frontend, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.cross_attn_every,
            cfg.n_img_tokens, cfg.vocab_padded) == \
        ("vlm", "vision", 40, 4096, 32, 8, 128, 14336, 5, 1601, 128256)
    with pytest.raises(KeyError):
        tcfg.get_config("qwen3-moe")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _assert_meta_tree_matches_reference(arch):
    from repro.models import RunConfig as JaxRunConfig, build as jax_build
    cfg = tcfg.get_config(arch)
    meta = dict(_leaves(build(cfg, RunConfig(device="cpu")).init_eval_shape()))
    ref = dict(_leaves(jax_build(jcfg.get_config(arch), JaxRunConfig()).init_eval_shape()))
    assert sorted(meta) == sorted(ref)
    for name, t in meta.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[name].shape), name
        assert str(t.dtype).removeprefix("torch.") == str(ref[name].dtype), name
    return cfg, sum(t.numel() for t in meta.values())


def test_meta_init_matches_reference_tree():
    """The full-width params tree, built on the meta device, has the JAX
    tree's keys, shapes and dtypes, and the analytic parameter count
    (which leaves out the final norm)."""
    cfg, n = _assert_meta_tree_matches_reference("qwen2-0.5b")
    assert n == cfg.param_count() + cfg.d_model


def test_mamba2_meta_tree_and_norm_count():
    """mamba2-2.7b's full-width tree matches the JAX tree. The analytic
    count takes 2 * d_model norm values per Mamba2 layer, but a layer
    holds ``ln`` (d_model) and ``gate_norm`` (d_inner = 2 * d_model), and
    the final norm is left out: the tree holds param_count() +
    n_layers * d_model + d_model values, in the port as in the reference."""
    cfg, n = _assert_meta_tree_matches_reference("mamba2-2.7b")
    assert cfg.ssm_d_inner == 2 * cfg.d_model
    assert n == cfg.param_count() + cfg.n_layers * cfg.d_model + cfg.d_model
    assert n == 2_831_730_176


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 96), dtype, scale=3.0)
    gj, gt = _pair(rng, (96,), dtype, scale=0.1)
    _close(jl.rms_norm(xj, gj, 1e-5), tl.rms_norm(xt, gt, 1e-5), TOL[dtype])


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype, gelu):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (2, 7, 64), dtype)
    ws = [_pair(rng, s, dtype, scale=0.125) for s in ((64, 160), (64, 160), (160, 64))]
    fj, ft = (jl.geglu, tl.geglu) if gelu else (jl.swiglu, tl.swiglu)
    _close(fj(xj, *(w[0] for w in ws)), ft(xt, *(w[1] for w in ws)), TOL[dtype])


def test_linear_bias_and_rope_freqs():
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, (3, 32), "float32")
    wj, wt = _pair(rng, (32, 48), "float32")
    bj, bt = _pair(rng, (48,), "float32")
    _close(jl.linear(xj, wj, bj), tl.linear(xt, wt, bt), 1e-5)
    for hd, theta in ((32, 10_000.0), (64, 1_000_000.0)):
        _close(jl.rope_freqs(hd, theta), tl.rope_freqs(hd, theta), 1e-7)


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype, decode):
    rng = np.random.default_rng(3)
    B, S, H, hd = 2, (1 if decode else 9), 3, 64
    xj, xt = _pair(rng, (B, S, H, hd), dtype)
    if decode:   # one position per sequence, as decode_step builds them
        pos = np.full((B, 1), 37, np.int32)
    else:
        pos = np.arange(S, dtype=np.int32)[None, :]
    _close(jl.apply_rope(xj, jnp.asarray(pos), 10_000.0),
           tl.apply_rope(xt, torch.from_numpy(pos), 10_000.0), TOL[dtype])


# ---------------------------------------------------------------------------
# initialisers and devices
# ---------------------------------------------------------------------------
def test_init_distributions():
    gen = torch.Generator().manual_seed(0)
    fan_in, scale = 256, 0.5
    w = tl.dense_init(gen, (fan_in, 4096), torch.float32, "cpu", scale=scale)
    std = scale / fan_in ** 0.5
    # a unit normal truncated to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    e = tl.embed_init(gen, (512, 512), torch.bfloat16, "cpu")
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) < 5e-4
    again = tl.dense_init(torch.Generator().manual_seed(0), (fan_in, 4096),
                          torch.float32, "cpu", scale=scale)
    assert torch.equal(w, again)


def test_cuda_is_the_default_and_is_never_faked():
    assert RunConfig().device == "cuda"
    assert tl.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tl.resolve_device("cuda").type == "cuda"
        return
    cfg = tcfg.get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.resolve_device("cuda")
