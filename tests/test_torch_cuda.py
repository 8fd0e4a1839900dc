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
through ``FlashAttentionFn`` (K1 forward, ``ref.attention_bwd``
backward); its dq, dk, dv are held against autograd through the plain
version (f32 1e-4, bf16 5e-2, as in ``chip_smoke.py``) and against
``attention_bwd`` on K1's own output (1e-6: the same function of the
same tensors). A CUDA SSD scan under a gradient raises.

Models: the reduced qwen2-0.5b, mamba2-2.7b, zamba2-1.2b (hybrid) and
gemma-7b at head_dim 256 decode token by token to their forward's f32
logits (2e-3) with the launch counts checked; a Mamba2 layer under
``RunConfig(ssd_chunk=256)`` (above K2's 128) runs K2 at the largest
chunk it takes and agrees with the CPU's scan at 256.
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
# training: K1 under a gradient, K2 refusing one, a reduced train step
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,H,K,hd", [(2, 200, 200, 14, 2, 64), (2, 128, 128, 4, 4, 32),
                                          (1, 77, 130, 4, 1, 128), (2, 64, 64, 14, 14, 64),
                                          (1, 77, 130, 8, 2, 256), (2, 64, 64, 4, 4, 256)])
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
    assert ops.attention.launches == before + 1          # the backward launches no K1
    direct = ref.attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(), dout,
                               causal=causal)
    plain = torch.autograd.grad(ref.attention_ref(q, k, v, causal=causal), (q, k, v), dout)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 5e-2
    for g, d, e in zip(got, direct, plain):
        assert g.dtype == dt and g.abs().sum() > 0
        torch.testing.assert_close(g, d, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(g.float(), e.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_attention_without_grad_launches_k1_plainly(card):
    q = torch.randn((1, 16, 4, 64), device=card, requires_grad=True)
    with torch.no_grad():
        out = ops.attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.cuda
def test_ssd_raises_under_grad_on_card(card):
    x, dt, A, B, C, _ = _ssd_inputs(card, 1, 32, 2, 16, 16, torch.float32, torch.float32)
    before = ops.ssd.launches
    with pytest.raises(NotImplementedError, match="SSM-training"):
        ops.ssd(x.requires_grad_(True), dt, A, B, C, chunk=16)
    with torch.no_grad():
        ops.ssd(x, dt, A, B, C, chunk=16)
    assert ops.ssd.launches == before + 1


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
