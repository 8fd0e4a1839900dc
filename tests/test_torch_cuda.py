"""The port on a CUDA card: K1 and K2 themselves and the reduced models' cache paths.

Every test here is marked ``cuda`` and skips without a card. This file
imports no JAX (the machine with the card has none); run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

f32 comparisons are made with TF32 off; K1's tolerances are those of
chip_smoke.py (f32 1e-5, bf16 2e-2), and K2's are the JAX kernel
tests': against ``ref.ssd_ref`` f32 2e-3 and bf16 5e-2, against
``models.ssm.ssd_chunked`` (f32) 2e-4. K1 takes k/v with K heads
(H % K == 0); bf16 runs its tensor-core kernel, f32 its scalar one. K2's
bf16 x with bf16 B/C runs its tensor-core scan, whose f32 state is held
to f32's 2e-3 against ``ssd_ref`` as well.

Training: ``ops.attention`` on CUDA tensors that require grad goes
through ``FlashAttentionFn`` (K1 forward; K1's backward kernel for bf16
at hd 32, 64 and 128, ``ref.attention_bwd`` for f32 and hd 256); its dq,
dk, dv are held against autograd through the plain version (f32 1e-4,
bf16 5e-2, as in ``chip_smoke.py``) and against ``attention_bwd`` on
K1's own output: f32 1e-6 (the same function of the same tensors), bf16
5e-2 of each element and 1e-2 of each tensor's norm (the kernel rounds P
and dS to bf16 for the tensor cores, as the forward rounds P), also at
query offsets. The kernel's gradients are
bit-equal from call to call, the log-sum-exp the forward writes for it
is that of the scaled scores (1e-5), and the counts
``ops.attention.bwd_launches`` / ``bwd_plain`` show which backward ran. ``ops.ssd`` under a gradient goes through ``SSDScanFn``
(K2 forward, the autograd of ``ssd_chunked`` as backward); its
gradients are held against autograd through ``ssd_chunked`` (1e-6 of
the largest value) and ``ref.ssd_ref`` (f32 2e-3, bf16 5e-2), and a
reduced zamba2-1.2b train step on the card against the CPU's (1e-4),
with remat off, "full" and "dots".

Models: the reduced qwen2-0.5b, mamba2-2.7b, zamba2-1.2b (hybrid) and
gemma-7b at head_dim 256 decode token by token to their forward's f32
logits (2e-3) with the launch counts checked; so do the reduced
qwen2-moe-a2.7b and llama4-scout-17b-a16e (at capacity factor 16,
drop-free), musicgen-medium (frame embeddings in) and
llama-3.2-vision-11b (gates set to 1, image embeddings in; K1 in every
cross block of the prefill and of each decode step), after a prefill of
the first 5 positions. K1 is held against its plain version at the
vlm's two cross-attention shapes (B=8, T=1601 image keys, H=32 over
K=8, hd 128, not causal; S=512 and S=1). A Mamba2 layer under
``RunConfig(ssd_chunk=256)`` (above K2's 128) runs K2 at the largest
chunk it takes and agrees with the CPU's scan at 256.

Training of the moe, audio and vlm families: one f32 step of the
reduced qwen2-moe-a2.7b, musicgen-medium and llama-3.2-vision-11b
(gates 0.5) on the card against the CPU's, remat off and "full", with
K1's launches a step as ``chip_smoke.expected_train_launches`` counts
them (the vlm's cross blocks once, its rematted self-attention layers
twice), and ``FlashAttentionFn``'s gradients at a ragged non-causal
cross-like shape (S=100, T=333, H=32 over K=8, hd 128).

gemma-7b's training and the two largest models' GQA groups: the reduced
gemma-7b at head_dim 256 takes an f32 step on the card against the
CPU's, remat off and "full" (K1 at hd 256 under a gradient, 4 and 8
launches); ``FlashAttentionFn``'s gradients at H=16 over K=2 (deepseek-
67b's group of 8) and H=10 over K=2 (llama4-scout-17b-a16e's group of
5). The sharded control plane: inline, its pods run on the card; its
workers forked after this process initialised CUDA cannot, and fail as a
``ShardFailure`` (the reference forks too). K1 and K2 on an empty batch
(a rank holding no row of a micro-batch) launch nothing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import RunConfig, build  # noqa: E402
from repro_torch.models.ssm import apply_mamba, init_mamba, ssd_chunked  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime.train import (TrainRunConfig, build_train_step,  # noqa: E402
                                       init_sharded_state, value_and_grad)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,hd", [(2, 200, 200, 14, 64), (1, 128, 96, 4, 32),
                                        (2, 64, 64, 2, 128), (1, 1, 1, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_matches_plain(card, B, S, T, H, hd, dtype, causal):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((B, n, H, hd), generator=gen, device=card)
               .to(TORCH_DTYPE[dtype]) for n in (S, T, T))
    before = ops.attention.launches
    out = ops.attention(q, k, v, causal=causal)
    assert ops.attention.launches == before + 1
    expect = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K", [(2, 200, 200, 14, 2), (1, 77, 130, 14, 1),
                                       (2, 128, 128, 4, 1), (1, 1, 1, 14, 2)])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_gqa_matches_plain(card, B, S, T, H, K, hd, dtype, causal):
    gen = torch.Generator(device=card).manual_seed(1)
    q = torch.randn((B, S, H, hd), generator=gen, device=card).to(TORCH_DTYPE[dtype])
    k, v = (torch.randn((B, T, K, hd), generator=gen, device=card).to(TORCH_DTYPE[dtype])
            for _ in range(2))
    before = ops.attention.launches
    out = ops.attention(q, k, v, causal=causal)
    assert ops.attention.launches == before + 1
    expect = ref.attention_ref(q, k, v, causal=causal)
    assert torch.equal(expect, ref.attention_ref(q, ref.repeat_kv(k, H), ref.repeat_kv(v, H),
                                                 causal=causal))
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_cross_attention_shapes_match_plain(card, S, dtype):
    """llama-3.2-vision-11b's cross-attention: S=512 queries in the prefill,
    1 in a decode step, over 1601 image keys (a ragged last tile)."""
    gen = torch.Generator(device=card).manual_seed(S)
    q = torch.randn((8, S, 32, 128), generator=gen, device=card).to(TORCH_DTYPE[dtype])
    k, v = (torch.randn((8, 1601, 8, 128), generator=gen, device=card)
            .to(TORCH_DTYPE[dtype]) for _ in range(2))
    before = ops.attention.launches
    out = ops.attention(q, k, v, causal=False)
    assert ops.attention.launches == before + 1
    expect = ref.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_k1_refuses_kv_heads_that_do_not_divide_h(card):
    q = torch.zeros((1, 8, 14, 64), device=card, dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 4, 64), device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="divides H"):
        ops.attention(q, kv, kv)


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 8, 2, 64), device=card)
    for bad in (q.half(), q[..., :48].contiguous(), q.transpose(1, 2),
                torch.zeros((1, 8, 2, 96), device=card)):
        with pytest.raises(ValueError):
            ops.attention(bad, bad, bad)


def _decode_matches_forward(card, cfg, expect_launches):
    """A reduced f32 model on the card: forward launches ``expect_launches``
    ({"attention": n, "ssd": m}), token-by-token decode launches neither
    kernel and gives the forward's logits."""
    model = build(cfg, RunConfig(param_dtype=torch.float32,
                                 compute_dtype=torch.float32, device="cuda"))
    params = model.init(torch.Generator(device=card).manual_seed(0))
    B, S = 2, 12
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(card)
    before = {"attention": ops.attention.launches, "ssd": ops.ssd.launches}

    def launched():
        return {"attention": ops.attention.launches - before["attention"],
                "ssd": ops.ssd.launches - before["ssd"]}
    full, _, _ = model.apply(params, {"tokens": tokens})
    assert launched() == expect_launches
    cache = model.init_cache(B, S)
    outs = []
    for t in range(S):
        logits, cache = model.decode(params, cache, {"tokens": tokens[:, t:t + 1]})
        outs.append(logits)
    assert launched() == expect_launches                  # decode launches none
    err = (torch.cat(outs, dim=1) - full).abs().max()
    assert float(err) < 2e-3, float(err)


@pytest.mark.cuda
def test_reduced_model_decode_matches_forward_on_card(card):
    cfg = get_config("qwen2-0.5b").reduced()
    _decode_matches_forward(card, cfg, {"attention": cfg.n_layers, "ssd": 0})


@pytest.mark.cuda
def test_reduced_hybrid_decode_matches_forward_on_card(card):
    """Reduced zamba2-1.2b (4 Mamba2 layers, the shared block after layers
    2 and 4): 2 K1 and 4 K2 launches in the forward."""
    cfg = get_config("zamba2-1.2b").reduced()
    _decode_matches_forward(card, cfg, {"attention": 2, "ssd": 4})


@pytest.mark.cuda
def test_reduced_gemma_head_dim_256_decode_matches_forward_on_card(card):
    """Reduced gemma-7b at its own head_dim of 256 (GeGLU, scaled and tied
    embeddings): K1 at hd 256 once per layer."""
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), head_dim=256)
    _decode_matches_forward(card, cfg, {"attention": cfg.n_layers, "ssd": 0})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                                  "musicgen-medium", "llama-3.2-vision-11b"])
def test_reduced_moe_audio_vlm_decode_matches_forward_on_card(card, arch):
    """prefill(inputs[:5]) + decode(inputs[5:]) against forward(inputs),
    f32 (2e-3): K1 once per layer (and cross block) in the forward and
    the prefill, once per cross block in each decode step."""
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = build(cfg, RunConfig(param_dtype=torch.float32,
                                 compute_dtype=torch.float32, device="cuda"))
    params = model.init(torch.Generator(device=card).manual_seed(0))
    n_cross = cfg.n_layers // cfg.cross_attn_every if cfg.family == "vlm" else 0
    if n_cross:
        params["cross_blocks"]["gate"].fill_(1.0)
    B, S, split = 2, 12, 5
    gen = torch.Generator(device=card).manual_seed(1)
    if cfg.frontend == "audio":
        batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=gen, device=card)}
    else:
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(card)}
        if cfg.frontend == "vision":
            batch["img_embeds"] = torch.randn((B, cfg.n_img_tokens, cfg.d_model),
                                              generator=gen, device=card)
    key = "embeds" if cfg.frontend == "audio" else "tokens"
    before = ops.attention.launches
    full, _, _ = model.apply(params, batch)
    assert ops.attention.launches - before == cfg.n_layers + n_cross
    _, cache = model.prefill(params, {k: v[:, :split] if k == key else v
                                      for k, v in batch.items()})
    pad = (0, 0, 0, 0, 0, S - split)
    cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                 v=torch.nn.functional.pad(cache["v"], pad))
    before = ops.attention.launches
    outs = []
    for t in range(split, S):
        logits, cache = model.decode(params, cache, {key: batch[key][:, t:t + 1]})
        outs.append(logits)
    assert ops.attention.launches - before == (S - split) * n_cross
    err = (torch.cat(outs, dim=1) - full[:, split:]).abs().max()
    assert float(err) < 2e-3, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_chunk_above_k2s_limit_matches_cpu(card, dtype):
    """RunConfig(ssd_chunk=256): the CPU scans at 256 (the JAX package's
    chunk), the card at ssd_scan.kernel_chunk(512, 256) = 128 through K2,
    one launch; outputs and state agree within K2's tolerance against
    ssd_chunked (f32 2e-4), or the bf16 apply_mamba tolerance (2e-2)."""
    cfg = get_config("mamba2-2.7b").reduced()
    dt = TORCH_DTYPE[dtype]
    params = init_mamba(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    params = {k: v if k in ("A_log", "dt_bias", "D_skip", "gate_norm") else v.to(dt)
              for k, v in params.items()}
    x = torch.randn((2, 512, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(dt)
    rc = RunConfig(compute_dtype=dt, device="cpu", ssd_chunk=256)
    y_cpu, st_cpu = apply_mamba(params, x, cfg, rc, return_state=True)
    before = ops.ssd.launches
    y, st = apply_mamba({k: v.to(card) for k, v in params.items()}, x.to(card), cfg,
                        rc.replace(device="cuda"), return_state=True)
    torch.cuda.synchronize()
    assert ops.ssd.launches == before + 1
    assert ssd_mod.kernel_chunk(512, 256) == 128
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.cpu().float(), y_cpu.float(), atol=tol, rtol=tol)
    for got, expect in zip(st, st_cpu):
        torch.testing.assert_close(got.cpu().float(), expect.float(), atol=tol, rtol=tol)


def _ssd_inputs(card, b, s, h, p, n, x_dtype, bc_dtype, with_init=False):
    gen = torch.Generator(device=card).manual_seed(b * 1000 + s + h * 10 + p + n)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card)
    x = randn(b, s, h, p).to(x_dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -torch.exp(randn(h) * 0.3)
    B = (randn(b, s, n) * 0.5).to(bc_dtype)
    C = (randn(b, s, n) * 0.5).to(bc_dtype)
    init = randn(b, h, p, n) * 0.5 if with_init else None
    return x, dt, A, B, C, init


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 8, 64, 128, 128),    # mamba2-2.7b's (P, N)
    (2, 96, 4, 64, 128, 96),      # S=96 -> chunk 96
    (2, 256, 4, 64, 64, 128),     # zamba2-1.2b's (P, N)
    (2, 24, 4, 16, 16, 12),       # reduced configs, S=24 -> chunk 12
    (1, 13, 2, 8, 16, 1),         # a prime S -> chunk 1
    (1, 64, 2, 8, 16, 16),        # tests/test_kernels.py's SSD_SHAPES
    (2, 128, 4, 16, 32, 32),
    (1, 128, 8, 32, 64, 64),
    (2, 96, 2, 16, 16, 48),
])
@pytest.mark.parametrize("dtypes", ["float32", "bfloat16", "bf16 x, f32 B/C"])
@pytest.mark.parametrize("with_init", [False, True])
def test_k2_matches_plain(card, b, s, h, p, n, chunk, dtypes, with_init):
    x_dtype = torch.float32 if dtypes == "float32" else torch.bfloat16
    bc_dtype = torch.bfloat16 if dtypes == "bfloat16" else torch.float32
    x, dt, A, B, C, init = _ssd_inputs(card, b, s, h, p, n, x_dtype, bc_dtype, with_init)
    before = ops.ssd.launches
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init)
    assert ops.ssd.launches == before + 1
    y_ref, st_ref = ref.ssd_ref(x, dt, A, B, C, init_state=init)
    torch.cuda.synchronize()
    assert y.dtype == x_dtype and st.dtype == torch.float32
    tol = 2e-3 if x_dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, st_ref, atol=tol, rtol=tol)
    if dtypes == "float32":
        y_c, st_c = ssd_chunked(x, dt, A, B, C, chunk, init_state=init)
        torch.testing.assert_close(y, y_c, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(st, st_c, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [128, 96, 48, 12, 1])
@pytest.mark.parametrize("p,n", [(64, 128), (64, 64), (16, 16)])
def test_k2_bf16_tensor_core_path(card, chunk, p, n):
    """Chunks and N that are not multiples of 16 are padded in shared memory."""
    b, h = 2, 4
    s = 2 * chunk if chunk > 1 else 7
    x, dt, A, B, C, init = _ssd_inputs(card, b, s, h, p, n, torch.bfloat16, torch.bfloat16,
                                       with_init=True)
    assert ssd_mod.kernel_path(x.dtype, B.dtype) == "mma"
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init)
    y_ref, st_ref = ref.ssd_ref(x, dt, A, B, C, init_state=init)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(st, st_ref, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_and_k2_on_an_empty_batch_launch_nothing(card, dtype):
    """A rank that holds no row of a micro-batch (fewer rows than dp ranks)
    calls K1 and K2 on an empty batch: empty outputs, no launch counted,
    and the gradient flows (K1 under autograd) as an empty one."""
    dt_ = TORCH_DTYPE[dtype]
    q, k, v = (torch.zeros((0, 64, n, 64), dtype=dt_, device=card, requires_grad=True)
               for n in (4, 2, 2))
    launches = ops.attention.launches
    out = ops.attention(q, k, v, causal=True)
    out.float().sum().backward()
    assert out.shape == q.shape and q.grad.shape == q.shape
    assert ops.attention.launches == launches
    x, dt, A, B, C, _ = _ssd_inputs(card, 1, 32, 2, 16, 16, dt_, dt_)
    launches = ops.ssd.launches
    y, st = ops.ssd(x[:0], dt[:0], A, B[:0], C[:0], chunk=16)
    torch.cuda.synchronize()
    assert y.shape == (0, 32, 2, 16) and st.shape == (0, 2, 16, 16)
    assert ops.ssd.launches == launches


@pytest.mark.cuda
def test_k2_refuses_what_it_does_not_take(card):
    x, dt, A, B, C, _ = _ssd_inputs(card, 1, 32, 2, 16, 16, torch.float32, torch.float32)
    noncontiguous = x.transpose(2, 3).contiguous().transpose(2, 3)
    for bad_x, chunk in ((x.half(), 16), (noncontiguous, 16), (x, 256), (x, 12)):
        with pytest.raises(ValueError):
            ops.ssd(bad_x, dt, A, B, C, chunk=chunk)


@pytest.mark.cuda
def test_reduced_mamba2_decode_matches_forward_on_card(card):
    cfg = get_config("mamba2-2.7b").reduced()
    _decode_matches_forward(card, cfg, {"attention": 0, "ssd": cfg.n_layers})


# ---------------------------------------------------------------------------
# training: K1 and K2 under a gradient, reduced train steps
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd", [(2, 200, 200, 14, 2, 64), (2, 128, 128, 4, 4, 32),
                                          (1, 77, 130, 4, 1, 128), (2, 64, 64, 14, 14, 64),
                                          (1, 77, 130, 8, 2, 256), (2, 64, 64, 4, 4, 256),
                                          (2, 100, 333, 32, 8, 128),    # the vlm's cross
                                          (2, 100, 100, 16, 2, 128),    # GQA group 8
                                          (2, 100, 100, 10, 2, 128)])   # GQA group 5
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_grads_match_plain(card, B, S, T, H, K, hd, dtype, causal):
    gen = torch.Generator(device=card).manual_seed(2)
    dt = TORCH_DTYPE[dtype]
    q = torch.randn((B, S, H, hd), generator=gen, device=card).to(dt).requires_grad_(True)
    k, v = (torch.randn((B, T, K, hd), generator=gen, device=card).to(dt).requires_grad_(True)
            for _ in range(2))
    dout = torch.randn((B, S, H, hd), generator=gen, device=card).to(dt)
    before = ops.attention.launches
    out = ops.attention(q, k, v, causal=causal)
    assert ops.attention.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert ops.attention.launches == before + 1          # the backward launches no K1 forward
    direct = ref.attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(), dout,
                               causal=causal)
    plain = torch.autograd.grad(ref.attention_ref(q, k, v, causal=causal), (q, k, v), dout)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 5e-2
    # f32 runs attention_bwd itself; bf16 the kernel, held at bf16's tolerance
    # and, as a whole tensor, by its relative norm error
    direct_tol = 1e-6 if dtype == "float32" else 5e-2
    for g, d, e in zip(got, direct, plain):
        assert g.dtype == dt and g.abs().sum() > 0
        torch.testing.assert_close(g.float(), d.float(), atol=direct_tol, rtol=direct_tol)
        assert dtype == "float32" or _rel_norm_err(g, d) <= BWD_REL_NORM_TOL
        torch.testing.assert_close(g.float(), e.float(), atol=tol, rtol=tol)


# the bf16 backward kernel's dq, dk, dv against attention_bwd, each by
# ||g - e|| / ||e|| (chip_smoke.py's K1_BWD_REL_TOL): bf16's rounding of P,
# dS and the outputs gives a few 1e-3; an element-wise 5e-2 alone would pass
# a kernel 10% wrong on most rows
BWD_REL_NORM_TOL = 1e-2


def _rel_norm_err(g, e) -> float:
    return float((g.float() - e.float()).norm() / e.float().norm())


def _grad_inputs(card, B, S, T, H, K, hd, dtype, seed=2):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device=card).to(dtype).requires_grad_(True)
    k, v = (torch.randn((B, T, K, hd), generator=gen, device=card).to(dtype).requires_grad_(True)
            for _ in range(2))
    dout = torch.randn((B, S, H, hd), generator=gen, device=card).to(dtype)
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,q_offset", [
    (2, 128, 512, 14, 2, 64, 384),      # qwen2-0.5b's last row block at tp=4
    (2, 100, 333, 12, 2, 128, 200),     # a ragged block inside T
    (1, 64, 130, 10, 2, 128, 66)])      # G = 5, ragged T
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fn_grads_at_a_q_offset_match_plain(card, B, S, T, H, K, hd,
                                                            q_offset, dtype):
    dt = TORCH_DTYPE[dtype]
    q, k, v, dout = _grad_inputs(card, B, S, T, H, K, hd, dt)
    out = ops.attention(q, k, v, causal=True, q_offset=q_offset)
    got = torch.autograd.grad(out, (q, k, v), dout)
    direct = ref.attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(), dout,
                               causal=True, q_offset=q_offset)
    plain = torch.autograd.grad(ref.attention_ref(q, k, v, causal=True, q_offset=q_offset),
                                (q, k, v), dout)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 5e-2
    direct_tol = 1e-6 if dtype == "float32" else 5e-2
    for g, d, e in zip(got, direct, plain):
        assert g.dtype == dt and g.abs().sum() > 0
        torch.testing.assert_close(g.float(), d.float(), atol=direct_tol, rtol=direct_tol)
        assert dtype == "float32" or _rel_norm_err(g, d) <= BWD_REL_NORM_TOL
        torch.testing.assert_close(g.float(), e.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd,causal", [(4, 2048, 2048, 12, 2, 128, True),
                                                 (2, 100, 333, 32, 8, 128, False),
                                                 (2, 200, 200, 24, 24, 64, True)])
def test_k1_backward_kernel_is_bit_equal_from_call_to_call(card, B, S, T, H, K, hd, causal):
    """dQ comes from its own pass over q tiles and dK, dV of a KV head from
    a sum in head order: no atomics, so two backwards agree bit for bit."""
    q, k, v, dout = _grad_inputs(card, B, S, T, H, K, hd, torch.bfloat16)
    first = torch.autograd.grad(ops.attention(q, k, v, causal=causal), (q, k, v), dout)
    second = torch.autograd.grad(ops.attention(q, k, v, causal=causal), (q, k, v), dout)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,causal,q_offset", [(200, 200, True, 0), (100, 333, False, 0),
                                                 (128, 512, True, 384), (300, 100, True, 0)])
def test_k1_writes_the_log_sum_exp_of_the_scaled_scores(card, S, T, causal, q_offset):
    from repro_torch.kernels import flash_attention as fa
    B, H, K, hd = 2, 14, 2, 64
    q, k, v, _ = (t.detach() for t in _grad_inputs(card, B, S, T, H, K, hd, torch.bfloat16))
    lse = torch.full((B, H, S), float("nan"), device=card)
    out = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset, lse=lse)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset))
    s = torch.einsum("bshd,bthd->bhst", q.float(), ref.repeat_kv(k, H).float()) / hd ** 0.5
    if causal:
        s = torch.where(ref.causal_mask(S, T, q_offset, card), s, torch.full_like(s, -1e30))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_backward_counts_show_which_backward_ran(card):
    """bf16 at hd 32, 64, 128 takes the kernel; f32 and hd 256 the plain
    backward; neither launches a K1 forward."""
    for dtype, hd, kernel in ((torch.bfloat16, 32, True), (torch.bfloat16, 64, True),
                              (torch.bfloat16, 128, True), (torch.bfloat16, 256, False),
                              (torch.float32, 64, False), (torch.float32, 128, False)):
        q, k, v, dout = _grad_inputs(card, 1, 70, 70, 4, 2, hd, dtype)
        out = ops.attention(q, k, v, causal=True)
        counts = (ops.attention.launches, ops.attention.bwd_launches, ops.attention.bwd_plain)
        torch.autograd.grad(out, (q, k, v), dout)
        assert (ops.attention.launches, ops.attention.bwd_launches,
                ops.attention.bwd_plain) == (counts[0], counts[1] + kernel,
                                             counts[2] + (not kernel)), (dtype, hd)


@pytest.mark.cuda
def test_attention_without_grad_launches_k1_plainly(card):
    q = torch.randn((1, 16, 4, 64), device=card, requires_grad=True)
    with torch.no_grad():
        out = ops.attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    assert out.grad_fn is None and not out.requires_grad


def _rel_err(got, expect):
    """Largest abs error over the expected gradient's largest abs value."""
    scale = float(expect.float().abs().max())
    return float((got.float() - expect.float()).abs().max()) / (scale or 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 64, 64, 32),       # zamba2-1.2b's (P, N) at the train chunk
    (2, 64, 4, 64, 128, 32),      # mamba2-2.7b's
    (2, 64, 4, 16, 16, 8),        # the reduced configs at the CPU tests' chunk
    (1, 13, 2, 8, 16, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_fn_grads_match_plain(card, b, s, h, p, n, chunk, dtype, with_init):
    """``ops.ssd`` under a gradient: K2 once in the forward, none in the
    backward; each gradient in its input's dtype, equal to autograd through
    ``ssd_chunked`` (the same function of the same tensors: 1e-6 of its
    largest value) and within f32 2e-3 / bf16 5e-2 of autograd through
    ``ref.ssd_ref``, the sequential recurrence."""
    dt_ = TORCH_DTYPE[dtype]
    x, dt, A, B, C, init = _ssd_inputs(card, b, s, h, p, n, dt_, dt_, with_init)
    inputs = [t.requires_grad_(True) for t in (x, dt, A, B, C, init) if t is not None]
    gen = torch.Generator(device=card).manual_seed(3)
    dy = torch.randn(x.shape, generator=gen, device=card).to(dt_)
    dfin = torch.randn((b, h, p, n), generator=gen, device=card)
    before = ops.ssd.launches
    y, fin = ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init)
    assert ops.ssd.launches == before + 1 and y.grad_fn is not None
    for outs, douts in (((y,), (dy,)), ((y, fin), (dy, dfin))):
        got = torch.autograd.grad(outs, inputs, douts, retain_graph=True)
        assert ops.ssd.launches == before + 1                 # the backward launches no K2
        y_c, fin_c = ssd_chunked(x, dt, A, B, C, chunk, init_state=init)
        chunked = torch.autograd.grad((y_c, fin_c)[:len(outs)], inputs, douts)
        y_r, fin_r = ref.ssd_ref(x, dt, A, B, C, init_state=init)
        plain = torch.autograd.grad((y_r, fin_r)[:len(outs)], inputs, douts)
        torch.cuda.synchronize()
        for g, c, r, t in zip(got, chunked, plain, inputs):
            assert g.dtype == t.dtype and g.shape == t.shape
            assert float(g.float().abs().sum()) > 0
            assert _rel_err(g, c) <= 1e-6
            assert _rel_err(g, r) <= (2e-3 if dtype == "float32" else 5e-2)


@pytest.mark.cuda
def test_ssd_without_grad_records_no_graph(card):
    x, dt, A, B, C, _ = _ssd_inputs(card, 1, 32, 2, 16, 16, torch.float32, torch.float32)
    x.requires_grad_(True)
    before = ops.ssd.launches
    with torch.no_grad():
        y, fin = ops.ssd(x, dt, A, B, C, chunk=16)
    with torch.inference_mode():
        y2, _ = ops.ssd(x.detach(), dt, A, B, C, chunk=16)
    assert ops.ssd.launches == before + 2
    assert y.grad_fn is None and not y.requires_grad and fin.grad_fn is None
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_reduced_qwen2_trains_on_card(card, compute):
    """Two steps on one batch: the loss falls, K1 launches once per layer and
    step, and the q/k/v projections get non-zero gradients through K1."""
    cfg = get_config("qwen2-0.5b").reduced()
    rc = RunConfig(param_dtype=torch.float32, compute_dtype=TORCH_DTYPE[compute],
                   device="cuda")
    step, *_, model = build_train_step(
        cfg, None, B=2, S=32, rc=rc,
        trc=TrainRunConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)))
    state = init_sharded_state(model, None, None, seed=0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
             .to(card) for k in ("tokens", "labels")}
    _, grads = value_and_grad(model.loss, state.params, batch)
    for name in ("wq", "wk", "wv", "wo"):
        assert float(grads["blocks"]["attn"][name].abs().sum()) > 0, name
    before = ops.attention.launches
    state, m1 = step(state, batch)
    state, m2 = step(state, batch)
    assert ops.attention.launches == before + 2 * cfg.n_layers
    assert bool(torch.isfinite(m1["loss"])) and bool(torch.isfinite(m2["grad_norm"]))
    assert float(m2["loss"]) < float(m1["loss"])
    assert int(state.step) == 2



@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_reduced_zamba2_train_step_on_card_matches_cpu(card, remat):
    """One f32 step of the reduced hybrid (4 Mamba2 layers, the shared block
    after layers 2 and 4) at chunk 8, from one state and one batch, on the
    card and on the CPU: loss, grad norm rel 1e-4, params, m and v 1e-4.
    Launches a step: K1 2 (the shared block is never rematted), K2 4, or 8
    under remat (the forward and the backward's recompute)."""
    cfg = get_config("zamba2-1.2b").reduced()
    flags = {"off": {}, "full": dict(remat=True, remat_policy="full"),
             "dots": dict(remat=True, remat_policy="dots")}[remat]
    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
                   ssd_chunk=8, **flags)
    trc = TrainRunConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    step_cpu, *_, model = build_train_step(cfg, None, B=2, S=32, rc=rc, trc=trc)
    step_card, *_ = build_train_step(cfg, None, B=2, S=32, rc=rc.replace(device="cuda"),
                                     trc=trc)
    state = init_sharded_state(model, None, None, seed=0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    new_cpu, met_cpu = step_cpu(state, batch)
    on_card = tree_map(lambda t: t.to(card), state)
    before = {"attention": ops.attention.launches, "ssd": ops.ssd.launches}
    new_card, met_card = step_card(on_card, {k: v.to(card) for k, v in batch.items()})
    torch.cuda.synchronize()
    n_ssd = cfg.n_layers * (1 if remat == "off" else 2)
    assert {"attention": ops.attention.launches - before["attention"],
            "ssd": ops.ssd.launches - before["ssd"]} == {"attention": 2, "ssd": n_ssd}
    for key in ("loss", "grad_norm", "lr"):
        assert float(met_card[key]) == pytest.approx(float(met_cpu[key]), rel=1e-4), key
    for a, b in zip(tree_leaves(new_card), tree_leaves(new_cpu)):
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=1e-4, rtol=0)


def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _frontend_batch(cfg, B, S, seed):
    """A train batch of ``cfg``'s frontend on the CPU: labels, and tokens,
    frame embeddings (audio) or tokens and image embeddings (vision)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    if cfg.frontend == "audio":
        batch["embeds"] = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                                           .astype(np.float32))
    else:
        batch["tokens"] = torch.from_numpy(np.ascontiguousarray(toks[:, :-1]))
    if cfg.frontend == "vision":
        batch["img_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["off", "full"])
@pytest.mark.parametrize("arch,launches", [
    ("qwen2-moe-a2.7b", {"off": 4, "full": 8}),
    ("musicgen-medium", {"off": 4, "full": 8}),
    # 4 self-attention layers (rematted: twice) and 2 cross blocks (never
    # rematted: once), so 2 * 4 + 2 = 10, not 2 * (4 + 2)
    ("llama-3.2-vision-11b", {"off": 6, "full": 10}),
])
def test_reduced_moe_audio_vlm_train_step_on_card_matches_cpu(card, arch, launches, remat):
    """One f32 step of the reduced moe, audio and vlm models (the vlm's gates
    at 0.5) from one state and one batch, on the card and on the CPU: every
    gradient leaf within 1e-4 of its largest value; loss, grad norm rel
    1e-4; params, m and v 1e-4 (peak lr 1e-4). K1 launches a step as
    ``chip_smoke.expected_train_launches`` counts them."""
    _train_step_on_card_matches_cpu(card, get_config(arch).reduced(), remat, launches[remat])


@pytest.mark.cuda
@pytest.mark.parametrize("remat,launches", [("off", 4), ("full", 8)])
def test_reduced_gemma_head_dim_256_train_step_on_card_matches_cpu(card, remat, launches):
    """The same for the reduced gemma-7b at its head_dim of 256 (GeGLU,
    scaled and tied embeddings): K1 at hd 256 under a gradient, through
    ``FlashAttentionFn``, once a layer, twice under remat."""
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), head_dim=256)
    _train_step_on_card_matches_cpu(card, cfg, remat, launches)


def _train_step_on_card_matches_cpu(card, cfg, remat, launches):
    flags = {} if remat == "off" else dict(remat=True, remat_policy="full")
    rc = RunConfig(param_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
                   **flags)
    trc = TrainRunConfig(opt=OptConfig(lr=1e-4, warmup_steps=1, total_steps=10))
    step_cpu, *_, model = build_train_step(cfg, None, B=2, S=32, rc=rc, trc=trc)
    step_card, *_, model_card = build_train_step(cfg, None, B=2, S=32,
                                                 rc=rc.replace(device="cuda"), trc=trc)
    state = init_sharded_state(model, None, None, seed=0)
    if "cross_blocks" in state.params:
        state.params["cross_blocks"]["gate"].fill_(0.5)
    batch = _frontend_batch(cfg, 2, 32, seed=0)
    on_card = tree_map(lambda t: t.to(card), state)
    card_batch = {k: v.to(card) for k, v in batch.items()}
    _, g_cpu = value_and_grad(model.loss, state.params, batch)
    _, g_card = value_and_grad(model_card.loss, on_card.params, card_batch)
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        scale = float(b.abs().max()) or 1.0
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale
    new_cpu, met_cpu = step_cpu(state, batch)
    before = ops.attention.launches
    new_card, met_card = step_card(on_card, card_batch)
    torch.cuda.synchronize()
    assert ops.attention.launches - before == launches == \
        _chip_smoke().expected_train_launches(cfg, rc)["attention"]
    for key in ("loss", "grad_norm", "lr"):
        assert float(met_card[key]) == pytest.approx(float(met_cpu[key]), rel=1e-4), key
    for a, b in zip(tree_leaves(new_card), tree_leaves(new_cpu)):
        torch.testing.assert_close(a.cpu().float(), b.float(), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_matmul_payload_on_card(card):
    """The engine's real payload on the card: synchronised before it returns,
    finite, and the CPU run's ``y[0, :4]`` within 1e-4 (f32, TF32 off)."""
    from repro_torch.core.dag import Task
    from repro_torch.core.payloads import matmul_payload

    class Volume(dict):
        def put(self, key, value):
            self[key] = value
    got, expect = Volume(), Volume()
    task = Task(id="mm")
    matmul_payload(n=256)(got, task)                      # cuda: the default device
    assert torch.cuda.current_stream().query()            # nothing left queued
    matmul_payload(n=256, device="cpu")(expect, task)
    assert np.isfinite(got["mm/out"]).all()
    np.testing.assert_allclose(got["mm/out"], expect["mm/out"], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_serve_twin_on_card(card, compute):
    """The serve twin at reduced size on the card: the workflow's tokens are
    bit-equal to the plain loop's (the twin raises otherwise) and K1
    launches once per layer in the prefill pod, never in the decode pod."""
    from repro_torch.examples import serve_batch
    cfg = get_config("qwen2-0.5b").reduced()
    rc = RunConfig(param_dtype=torch.float32, compute_dtype=TORCH_DTYPE[compute],
                   device="cuda")
    params = build(cfg, rc).init(torch.Generator(device=card).manual_seed(0))
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 32))).to(card)
    out = serve_batch.run(cfg, params, prompts, gen=32, rc=rc)
    assert torch.equal(out["tokens"], out["plain_tokens"]) and out["order_consistent"]
    assert out["k1_launches"] == {"prefill": cfg.n_layers, "decode": 0}


@pytest.mark.cuda
def test_forked_shard_worker_cannot_use_the_card(card):
    """``ShardedControlPlane(processes=True)`` forks its workers, as the
    reference does: once this process has initialised CUDA, a worker whose
    payload runs on the card fails, and the failure comes back through the
    error pipe as a ``ShardFailure``, well inside the join deadline. Inline
    (``processes=False``) the same plane runs its pods on the card."""
    import time
    from repro_torch.core.dag import Task, Workflow
    from repro_torch.core.payloads import matmul_payload
    from repro_torch.core.shard import ShardedControlPlane, ShardFailure
    torch.zeros(1, device=card)                          # CUDA initialised here
    mm = matmul_payload(n=64, iters=1, device="cuda")
    edges = {"0": ([], ["1"]), "1": (["0"], [])}

    def plane(processes):
        p = ShardedControlPlane(2, payload_mode="real", seed=0, processes=processes,
                                heartbeat_s=0.5, shard_timeout_s=120.0)
        for tenant in ("batch-a", "prod-a"):             # shard 0 and shard 1
            p.add_stream(Workflow("pair", {tid: Task(id=tid, inputs=i, outputs=o, payload=mm)
                                           for tid, (i, o) in edges.items()}), tenant=tenant)
        return p
    assert plane(False).run().completed_workflows == 2
    t0 = time.monotonic()
    with pytest.raises(ShardFailure) as exc:
        plane(True).run()
    assert time.monotonic() - t0 < 60.0
    assert "CUDA" in exc.value.reason


# ---------------------------------------------------------------------------
# K1 at a query offset, and the mesh path at world size 1
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_q_offset_matches_plain(card, tp, hd, dtype):
    """Each rank's row block of a "seq" mesh (q_offset r * S / tp, against
    the full k/v) against the plain version at that offset, forward (f32
    1e-5, bf16 2e-2) and under a gradient (f32 1e-4, bf16 5e-2); together
    the blocks give the unsharded K1's output at the forward's bound."""
    B, S, H, K = 2, 256, 14, 2
    gen = torch.Generator(device=card).manual_seed(5)
    dt = TORCH_DTYPE[dtype]
    q = torch.randn((B, S, H, hd), generator=gen, device=card).to(dt)
    k, v = (torch.randn((B, S, K, hd), generator=gen, device=card).to(dt) for _ in range(2))
    tol, gtol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 5e-2)
    n, blocks = S // tp, []
    for r in range(tp):
        qb = q[:, r * n:(r + 1) * n].contiguous().requires_grad_(True)
        kb, vb = k.clone().requires_grad_(True), v.clone().requires_grad_(True)
        dout = torch.randn(qb.shape, generator=gen, device=card).to(dt)
        before = ops.attention.launches
        out = ops.attention(qb, kb, vb, causal=True, q_offset=r * n)
        assert ops.attention.launches == before + 1
        expect = ref.attention_ref(qb, kb, vb, causal=True, q_offset=r * n)
        torch.testing.assert_close(out.float(), expect.float(), atol=tol, rtol=tol)
        got = torch.autograd.grad(out, (qb, kb, vb), dout)
        plain = torch.autograd.grad(expect, (qb, kb, vb), dout)
        for g, e in zip(got, plain):
            torch.testing.assert_close(g.float(), e.float(), atol=gtol, rtol=gtol)
        blocks.append(out.detach())
    whole = ops.attention(q, k, v, causal=True)
    torch.testing.assert_close(torch.cat(blocks, 1).float(), whole.float(), atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="q_offset"):
        ops.attention(q[:, :n].contiguous(), k, v, causal=True, q_offset=S - n + 1)


@pytest.fixture
def world_of_one(card):
    """A default process group of one NCCL rank on this card, and its (1, 1) mesh."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_train_step_at_world_size_one_matches_no_mesh(card, world_of_one):
    """The reduced qwen2-0.5b's f32 step on the (1, 1) mesh against the same
    step without one: loss and params within 1e-6, 4 K1 launches each."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.parallel.sharding import specs_of
    from repro_torch.runtime.train import distribute
    from repro_torch.tree import tree_flatten_with_path
    mesh = world_of_one
    cfg = get_config("qwen2-0.5b").reduced()
    rc = RunConfig(compute_dtype=torch.float32, device="cuda")
    trc = TrainRunConfig(opt=OptConfig(lr=1e-3, warmup_steps=0))
    batch = {k: np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    step, *_, model = build_train_step(cfg, None, B=4, S=64, rc=rc, trc=trc)
    mstep, _, _, st_sh, b_sh, _ = build_train_step(cfg, mesh, B=4, S=64, rc=rc, trc=trc)
    state = init_sharded_state(model, None)
    before = ops.attention.launches
    new, met = step(state, {k: torch.from_numpy(v).to(card) for k, v in batch.items()})
    assert ops.attention.launches == before + cfg.n_layers
    mnew, mmet = mstep(distribute(state, st_sh), shard_batch(batch, mesh, specs_of(b_sh)))
    assert ops.attention.launches == before + 2 * cfg.n_layers
    assert abs(float(mmet["loss"]) - float(met["loss"])) <= 1e-6 * abs(float(met["loss"]))
    got = tree_flatten_with_path(mnew.params)
    for k, p in tree_flatten_with_path(new.params).items():
        torch.testing.assert_close(got[k].full_tensor(), p, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_k2_operators_are_the_launches(card, dtype):
    """``repro_torch::k1_fwd`` / ``k2_fwd``, the operators FlashAttentionFn and
    SSDScanFn call, give the launchers' outputs bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    dt_ = TORCH_DTYPE[dtype]
    gen = torch.Generator(device=card).manual_seed(5)
    q = torch.randn((2, 200, 14, 64), generator=gen, device=card).to(dt_)
    k, v = (torch.randn((2, 200, 2, 64), generator=gen, device=card).to(dt_) for _ in "kv")
    for causal, off in ((True, 0), (False, 0)):
        assert torch.equal(torch.ops.repro_torch.k1_fwd(q, k, v, causal, off),
                           fa.flash_attention(q, k, v, causal=causal, q_offset=off))
    assert torch.equal(torch.ops.repro_torch.k1_fwd(q[:, 100:].contiguous(), k, v, True, 100),
                       fa.flash_attention(q[:, 100:].contiguous(), k, v, causal=True,
                                          q_offset=100))
    x, dt, A, B, C, init = _ssd_inputs(card, 2, 256, 8, 64, 128, dt_, dt_, with_init=True)
    got = torch.ops.repro_torch.k2_fwd(x, dt, A, B, C, 128, init)
    expect = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=128, init_state=init)
    assert all(torch.equal(g, e) for g, e in zip(got, expect))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_on_a_tp4_ranks_local_heads_is_that_slice_of_the_whole(card, dtype):
    """mamba2-2.7b's scan (80 heads of P 64, N 128, chunk 128) cut as each
    rank of a model=4 mesh runs it (``ssm._local_ssd``: its 20 heads of x,
    dt, A and the state, B/C whole): bit-equal to those heads of the whole
    call, y and the final state."""
    dt_ = TORCH_DTYPE[dtype]
    x, dt, A, B, C, init = _ssd_inputs(card, 2, 256, 80, 64, 128, dt_, dt_, with_init=True)
    y, st = ops.ssd(x, dt, A, B, C, chunk=128, init_state=init)
    for r in range(4):
        h = slice(20 * r, 20 * r + 20)
        yl, stl = ops.ssd(x[:, :, h].contiguous(), dt[:, :, h].contiguous(), A[h].contiguous(),
                          B, C, chunk=128, init_state=init[:, h].contiguous())
        assert torch.equal(yl, y[:, :, h]) and torch.equal(stl, st[:, h]), r
