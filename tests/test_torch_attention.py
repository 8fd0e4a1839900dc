"""Parity of the port's attention and of K1's plain version with the JAX package.

K1 and its plain version take k/v with K heads (H % K == 0); the JAX
kernel and oracle take full-H k/v, so they get the ``repeat_kv`` copy.

The same numpy inputs go through ``repro.models.attention`` /
``repro.kernels`` (JAX on the CPU; the Pallas kernel in interpret mode)
and through ``repro_torch`` with device="cpu". GQA is covered at G = 2
(the reduced config) and G = 7 (qwen2-0.5b's 14 / 2 heads).

Tolerances: f32 agrees to rounding (2e-5). In bf16 the JAX
``full_attention`` rounds the scores to bf16 before its f32 softmax,
while the port's full-H path (K1, and ``attention_ref`` on the CPU)
computes them in f32, so ``apply_attention`` prefill differs by that
rounding only: the largest difference measured at these shapes (five
seeds, G = 2 and 7) was one bf16 ulp of the output, 3.9e-3 at
|out| ~ 1. The bf16 tolerance is 2e-2, absolute and relative.

K1's backward (``ref.attention_bwd``, the backward of
``FlashAttentionFn``) is held in f32 to 1e-5 against autograd through
``attention_ref`` and against ``jax.vjp`` of the JAX oracle on
``repeat_kv``'d inputs (dK and dV summed over each KV head's group);
in bf16 to 5e-2 against autograd, the tolerance ``chip_smoke.py`` uses
on the card (the backward reads the forward's bf16-rounded output in
rowsum(dO * O), where autograd uses the f32 one). ``ref.attention_bwd``
is the plain version that the card holds K1's backward kernel to, and
the backward that f32 and hd 256 take there.

K1's backward kernel on meta tensors: its operator ``repro_torch::k1_bwd``
shapes dq, dk and dv across GQA groups, S != T and query offsets and
counts the five products of a flash backward over the live pairs
(``flash_attention.bwd_flops``); ``FlashAttentionFn`` sends bf16 at hd
32, 64 and 128 to it (the forward then hands K1 a log-sum-exp to write)
and f32 and hd 256 to ``ref.attention_bwd``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models.layers import RunConfig as JaxRunConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref as tref  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models.layers import RunConfig  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, S, H, hd, block_q, block_k): small shapes of tests/test_kernels.py
K1_SHAPES = [
    (1, 128, 1, 64, 64, 64),
    (2, 128, 3, 32, 32, 64),
    (1, 256, 2, 128, 64, 128),
]


def _pair(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(TORCH_DTYPE[dtype])


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               atol=tol, rtol=tol)


def _cfg(groups):
    """Reduced qwen2-0.5b (H=4, K=2, hd=32) or a G=7 variant (H=14, K=2, hd=64)."""
    jc, tc = jax_config("qwen2-0.5b").reduced(), get_config("qwen2-0.5b").reduced()
    if groups == 7:
        jc = dataclasses.replace(jc, n_heads=14, head_dim=64)
        tc = dataclasses.replace(tc, n_heads=14, head_dim=64)
    return jc, tc


# ---------------------------------------------------------------------------
# the jnp attention paths
# ---------------------------------------------------------------------------
def test_repeat_kv_and_gqa_fold():
    rng = np.random.default_rng(0)
    kj, kt = _pair(rng, (2, 5, 2, 8), "float32")
    _close(ja.repeat_kv(kj, 14), ta.repeat_kv(kt, 14), 0)
    assert ta.repeat_kv(kt, 14).is_contiguous()
    assert ta.repeat_kv is tref.repeat_kv
    qj, qt = _pair(rng, (2, 1, 14, 8), "float32")
    _close(ja._gqa_fold(qj, 2), ta._gqa_fold(qt, 2), 0)


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention(dtype, causal, q_offset):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (2, 8, 3, 32), dtype)
    kj, kt = _pair(rng, (2, 13, 3, 32), dtype)
    vj, vt = _pair(rng, (2, 13, 3, 32), dtype)
    _close(ja.full_attention(qj, kj, vj, causal=causal, q_offset=q_offset),
           ta.full_attention(qt, kt, vt, causal=causal, q_offset=q_offset), TOL[dtype])


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention(dtype, chunk):
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (2, 64, 4, 32), dtype)
    kj, kt = _pair(rng, (2, 64, 4, 32), dtype)
    vj, vt = _pair(rng, (2, 64, 4, 32), dtype)
    _close(ja.chunked_attention(qj, kj, vj, chunk=chunk, causal=True),
           ta.chunked_attention(qt, kt, vt, chunk=chunk, causal=True),
           TOL[dtype])
    with pytest.raises(ValueError):
        ta.chunked_attention(qt, kt, vt, chunk=24)


@pytest.mark.parametrize("groups", [2, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(dtype, groups):
    rng = np.random.default_rng(3)
    B, T, K, hd, index = 2, 11, 2, 32, 6
    qj, qt = _pair(rng, (B, 1, K, groups, hd), dtype)
    kj, kt = _pair(rng, (B, T, K, hd), dtype)
    vj, vt = _pair(rng, (B, T, K, hd), dtype)
    _close(ja.decode_attention(qj, kj, vj, jnp.int32(index)),
           ta.decode_attention(qt, kt, vt, index), TOL[dtype])


@pytest.mark.parametrize("index", [0, 7, 9, 15])
def test_cache_write_clamps_like_dynamic_update_slice(index):
    rng = np.random.default_rng(4)
    cj, ct = _pair(rng, (2, 10, 2, 8), "float32")
    nj, nt = _pair(rng, (2, 1, 2, 8), "float32")
    expect = jax.lax.dynamic_update_slice_in_dim(cj, nj, jnp.int32(index), axis=1)
    ta._write_cache(ct, nt, index)       # in place
    _close(expect, ct, 0)


# ---------------------------------------------------------------------------
# apply_attention: prefill (full-H, through ops.attention) and decode
# ---------------------------------------------------------------------------
def _attn_params(jc, dtype, seed):
    p = ja.init_attention(jax.random.PRNGKey(seed), jc, jnp.float32)
    rng = np.random.default_rng(seed)
    tree = {k: np.asarray(v) for k, v in p.items()}
    for name in ("bq", "bk", "bv"):           # non-zero biases
        tree[name] = (rng.standard_normal(tree[name].shape) * 0.1).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.dtype(dtype)) for k, v in tree.items()}
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return jp, tp


@pytest.mark.parametrize("groups", [2, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_attention_prefill(dtype, groups):
    jc, tc = _cfg(groups)
    jp, tp = _attn_params(jc, dtype, seed=5)
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng, (2, 24, jc.d_model), dtype)
    pos = np.arange(24, dtype=np.int32)[None, :]
    before = ops.attention.launches
    out_j, (kj, vj) = ja.apply_attention(jp, xj, jc, JaxRunConfig(compute_dtype=dtype),
                                         jnp.asarray(pos), return_kv=True)
    out_t, (kt, vt) = ta.apply_attention(tp, xt, tc, RunConfig(device="cpu"),
                                         torch.from_numpy(pos), return_kv=True)
    assert ops.attention.launches == before      # the CPU runs the plain version
    _close(out_j, out_t, TOL[dtype])
    _close(kj, kt, TOL[dtype])
    _close(vj, vt, TOL[dtype])


@pytest.mark.parametrize("groups", [2, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_attention_decode(dtype, groups):
    jc, tc = _cfg(groups)
    jp, tp = _attn_params(jc, dtype, seed=6)
    rng = np.random.default_rng(6)
    B, T, index = 2, 12, 7
    K, hd = jc.n_kv_heads, jc.resolved_head_dim
    xj, xt = _pair(rng, (B, 1, jc.d_model), dtype)
    kcj, kct = _pair(rng, (B, T, K, hd), dtype)
    vcj, vct = _pair(rng, (B, T, K, hd), dtype)
    pos = np.full((B, 1), index, np.int32)
    out_j, (kj, vj) = ja.apply_attention(jp, xj, jc, JaxRunConfig(compute_dtype=dtype),
                                         jnp.asarray(pos), cache=(kcj, vcj),
                                         cache_index=jnp.int32(index))
    out_t, (kt, vt) = ta.apply_attention(tp, xt, tc, RunConfig(device="cpu"),
                                         torch.from_numpy(pos), cache=(kct, vct),
                                         cache_index=index)
    assert kt is kct and vt is vct               # written in place
    _close(out_j, out_t, TOL[dtype])
    _close(kj, kt, TOL[dtype])
    _close(vj, vt, TOL[dtype])


def test_cross_attention_names_its_slice():
    """Cross-attention, ported with the VLM slice: q from x, k and v from
    the image ``kv_x`` (no RoPE, no bias, not causal, through
    ``ops.attention``), and in decode k and v taken from the cache as they
    are (not written); f32 against the JAX package's apply_attention."""
    jc, tc = _cfg(2)
    p = ja.init_attention(jax.random.PRNGKey(7), jc, jnp.float32, cross=True)
    assert sorted(p) == ["wk", "wo", "wq", "wv"]               # no q/k/v bias
    tp = params_from_jax({k: np.asarray(v) for k, v in p.items()}, device="cpu")
    assert sorted(tp) == sorted(ta.init_attention(torch.Generator().manual_seed(0), tc,
                                                  torch.float32, "cpu", cross=True))
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, (2, 12, jc.d_model), "float32")
    imgj, imgt = _pair(rng, (2, 16, jc.d_model), "float32")
    rc, jrc = RunConfig(device="cpu", compute_dtype=torch.float32), JaxRunConfig()
    out_j, (kj, vj) = ja.apply_attention(p, xj, jc, jrc, None, kv_x=imgj, causal=False,
                                         return_kv=True, is_cross=True)
    calls = []
    attention = ops.attention

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return attention(q, k, v, causal=causal)
    ops.attention = spy
    try:
        out_t, (kt, vt) = ta.apply_attention(tp, xt, tc, rc, None, kv_x=imgt, causal=False,
                                             return_kv=True, is_cross=True)
        step_j, _ = ja.apply_attention(p, xj[:, :1], jc, jrc, None, causal=False,
                                       cache=(kj, vj), is_cross=True)
        kc, vc = kt.clone(), vt.clone()
        step_t, kv = ta.apply_attention(tp, xt[:, :1], tc, rc, None, causal=False,
                                        cache=(kc, vc), is_cross=True)
    finally:
        ops.attention = attention
    assert calls == [((2, 12, 4, 32), (2, 16, 2, 32), False),
                     ((2, 1, 4, 32), (2, 16, 2, 32), False)]
    _close(out_j, out_t, TOL["float32"])
    _close(kj, kt, TOL["float32"])
    _close(vj, vt, TOL["float32"])
    _close(step_j, step_t, TOL["float32"])
    assert kv[0] is kc and torch.equal(kc, kt) and torch.equal(vc, vt)   # read, not written


# ---------------------------------------------------------------------------
# K1: the plain version against the JAX oracle and the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,hd,bq,bk", K1_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_plain_matches_reference_and_pallas(B, S, H, hd, bq, bk, dtype, causal):
    rng = np.random.default_rng(B * 1000 + S + H * 10 + hd)
    qj, qt = _pair(rng, (B, S, H, hd), dtype)
    kj, kt = _pair(rng, (B, S, H, hd), dtype)
    vj, vt = _pair(rng, (B, S, H, hd), dtype)
    before = ops.attention.launches
    out = ops.attention(qt, kt, vt, causal=causal)
    assert ops.attention.launches == before
    assert out.dtype == qt.dtype and out.shape == qt.shape
    assert torch.equal(out, tref.attention_ref(qt, kt, vt, causal=causal))
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(jref.attention_ref(qj, kj, vj, causal=causal), out, tol)
    _close(jax_flash(qj, kj, vj, causal=causal, block_q=bq, block_k=bk,
                     interpret=True), out, tol)


@pytest.mark.parametrize("B,S,T,H,hd,blk", [(1, 64, 128, 4, 32, 64), (2, 128, 64, 4, 64, 64)])
@pytest.mark.parametrize("K", [4, 2, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_k1_plain_takes_grouped_kv(B, S, T, H, hd, blk, K, dtype, causal):
    """K-head k/v (K in {H, H/2, 1}, S != T) against the JAX oracle and the
    Pallas kernel on repeat_kv'd full-H inputs."""
    rng = np.random.default_rng(B * 100 + S + T + K)
    qj, qt = _pair(rng, (B, S, H, hd), dtype)
    kj, kt = _pair(rng, (B, T, K, hd), dtype)
    vj, vt = _pair(rng, (B, T, K, hd), dtype)
    before = ops.attention.launches
    out = ops.attention(qt, kt, vt, causal=causal)
    assert ops.attention.launches == before
    assert out.dtype == qt.dtype and out.shape == qt.shape
    assert torch.equal(out, tref.attention_ref(qt, kt, vt, causal=causal))
    assert torch.equal(out, tref.attention_ref(qt, tref.repeat_kv(kt, H),
                                               tref.repeat_kv(vt, H), causal=causal))
    kf, vf = ja.repeat_kv(kj, H), ja.repeat_kv(vj, H)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(jref.attention_ref(qj, kf, vf, causal=causal), out, tol)
    _close(jax_flash(qj, kf, vf, causal=causal, block_q=blk, block_k=blk, interpret=True),
           out, tol)


def test_attention_refuses_kv_heads_that_do_not_divide_h():
    q = torch.zeros((1, 8, 6, 32))
    kv = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError, match="divides H"):
        ops.attention(q, kv, kv)


@pytest.mark.parametrize("groups", [2, 7])
def test_apply_attention_prefill_hands_k_head_kv_to_the_kernel(groups, monkeypatch):
    """The prefill makes no repeat_kv copy: ops.attention gets (B, S, K, hd) k/v."""
    jc, tc = _cfg(groups)
    _, tp = _attn_params(jc, "float32", seed=8)
    seen = []
    plain = ops.attention

    def recording(q, k, v, *, causal=True):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), k.is_contiguous(),
                     v.is_contiguous()))
        return plain(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "attention", recording)
    B, S = 2, 24
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, tc.d_model)).astype(np.float32))
    pos = torch.arange(S)[None, :]
    out, _ = ta.apply_attention(tp, x, tc, RunConfig(device="cpu"), pos)
    H, K, hd = tc.n_heads, tc.n_kv_heads, tc.resolved_head_dim
    assert K < H
    assert seen == [((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), True, True)]
    assert out.shape == (B, S, tc.d_model)


def test_k1_launcher_takes_cuda_tensors_only():
    q = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q, causal=True)
    # the operator of the launch has no CPU implementation
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.k1_fwd(q, q, q, True, 0)
    # a meta tensor takes the kernel's way and is only shaped: no launch
    before = ops.attention.launches
    out = ops.attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert ops.attention.launches == before


def test_bf16_moves_bit_for_bit():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 97), jnp.bfloat16))
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


# ---------------------------------------------------------------------------
# K1 under a gradient: the backward and FlashAttentionFn's wiring
# ---------------------------------------------------------------------------
BWD_CASES = [
    # (B, S, T, H, K, hd, causal)
    (2, 24, 24, 4, 4, 32, True),      # K == H
    (2, 24, 24, 4, 2, 32, True),      # GQA, G = 2
    (2, 24, 24, 4, 1, 32, False),     # one KV head
    (2, 20, 20, 14, 2, 64, True),     # qwen2-0.5b's G = 7
    (1, 16, 40, 4, 2, 32, False),     # S < T, not causal
    (1, 16, 40, 4, 2, 64, True),      # S < T, causal
]


def _bwd_inputs(rng, B, S, T, H, K, hd, dtype="float32"):
    return [_pair(rng, shape, dtype) for shape in
            ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd), (B, S, H, hd))]


def _autograd_grads(q, k, v, dout, causal):
    inputs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = tref.attention_ref(*inputs, causal=causal)
    return torch.autograd.grad(out, inputs, dout)


@pytest.mark.parametrize("B,S,T,H,K,hd,causal", BWD_CASES)
def test_attention_bwd_matches_autograd_and_jax_vjp(B, S, T, H, K, hd, causal):
    rng = np.random.default_rng(B * 100 + S + T + H + K + hd)
    (qj, qt), (kj, kt), (vj, vt), (dj, dt) = _bwd_inputs(rng, B, S, T, H, K, hd)
    out = tref.attention_ref(qt, kt, vt, causal=causal)
    got = tref.attention_bwd(qt, kt, vt, out, dt, causal=causal)
    assert [tuple(g.shape) for g in got] == [tuple(qt.shape), tuple(kt.shape),
                                             tuple(vt.shape)]
    for g, e in zip(got, _autograd_grads(qt, kt, vt, dt, causal)):
        torch.testing.assert_close(g, e, atol=1e-5, rtol=1e-5)
    kf, vf = ja.repeat_kv(kj, H), ja.repeat_kv(vj, H)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, causal=causal), qj, kf, vf)
    gq, gk, gv = vjp(dj)
    G = H // K
    gk = np.asarray(gk).reshape(B, T, K, G, hd).sum(3)
    gv = np.asarray(gv).reshape(B, T, K, G, hd).sum(3)
    for g, e in zip(got, (gq, gk, gv)):
        _close(e, g, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_bf16_matches_autograd(causal):
    rng = np.random.default_rng(31)
    (_, qt), (_, kt), (_, vt), (_, dt) = _bwd_inputs(rng, 2, 32, 32, 14, 2, 64, "bfloat16")
    out = tref.attention_ref(qt, kt, vt, causal=causal)
    got = tref.attention_bwd(qt, kt, vt, out, dt, causal=causal)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    for g, e in zip(got, _autograd_grads(qt, kt, vt, dt, causal)):
        torch.testing.assert_close(g.float(), e.float(), atol=5e-2, rtol=5e-2)


def test_attention_bwd_refuses_kv_heads_that_do_not_divide_h():
    q = torch.zeros((1, 8, 6, 32))
    kv = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError, match="divides H"):
        tref.attention_bwd(q, kv, kv, q, q)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_wiring(monkeypatch, causal):
    """FlashAttentionFn with its K1 launch stood in for by the plain version
    (there is no card here): the forward's output and the backward's
    gradients are those of autograd through the plain version."""
    monkeypatch.setattr(torch.ops.repro_torch, "k1_fwd",
                        lambda q, k, v, causal, q_offset: tref.attention_ref(
                            q, k, v, causal=causal, q_offset=q_offset))
    rng = np.random.default_rng(32)
    (_, qt), (_, kt), (_, vt), (_, dt) = _bwd_inputs(rng, 2, 24, 24, 4, 2, 32)
    inputs = [t.requires_grad_(True) for t in (qt, kt, vt)]
    out = tfa.FlashAttentionFn.apply(*inputs, causal)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), tref.attention_ref(qt, kt, vt, causal=causal).detach())
    got = torch.autograd.grad(out, inputs, dt)
    for g, e in zip(got, _autograd_grads(qt, kt, vt, dt, causal)):
        torch.testing.assert_close(g, e, atol=1e-5, rtol=1e-5)


def test_cpu_attention_under_grad_is_the_plain_autograd():
    rng = np.random.default_rng(33)
    (_, qt), (_, kt), (_, vt), (_, dt) = _bwd_inputs(rng, 1, 12, 12, 4, 2, 32)
    inputs = [t.requires_grad_(True) for t in (qt, kt, vt)]
    before = ops.attention.launches
    out = ops.attention(*inputs, causal=True)
    assert ops.attention.launches == before and out.grad_fn is not None
    for g, e in zip(torch.autograd.grad(out, inputs, dt),
                    _autograd_grads(qt, kt, vt, dt, True)):
        assert torch.equal(g, e)



# ---------------------------------------------------------------------------
# K1's backward kernel on meta tensors: its operator's shapes, FLOPs, dispatch
# ---------------------------------------------------------------------------
META_BWD_CASES = [
    # (B, S, T, H, K, hd, causal, q_offset)
    (4, 2048, 2048, 12, 2, 128, True, 0),    # qwen2-1.5b's train shape
    (2, 20, 40, 14, 7, 64, True, 0),         # S < T, G = 2
    (2, 40, 20, 14, 2, 32, True, 0),         # S > T: rows past T see every key
    (2, 100, 333, 32, 8, 128, False, 0),     # the vlm's cross-attention
    (2, 128, 512, 14, 2, 64, True, 384),     # a "seq" rank's row block
    (1, 77, 130, 10, 2, 128, True, 50),      # G = 5 at an offset
]


def _meta_bwd_inputs(B, S, T, H, K, hd, dtype=torch.bfloat16):
    q, out, dout = (torch.empty((B, S, H, hd), dtype=dtype, device="meta") for _ in "qod")
    k, v = (torch.empty((B, T, K, hd), dtype=dtype, device="meta") for _ in "kv")
    lse = torch.empty((B, H, S), dtype=torch.float32, device="meta")
    return q, k, v, out, dout, lse


@pytest.mark.parametrize("B,S,T,H,K,hd,causal,q_offset", META_BWD_CASES)
def test_k1_bwd_fake_shapes_the_gradients(B, S, T, H, K, hd, causal, q_offset):
    from torch.utils.flop_counter import FlopCounterMode
    args = _meta_bwd_inputs(B, S, T, H, K, hd)
    with FlopCounterMode(display=False) as counter:
        dq, dk, dv = torch.ops.repro_torch.k1_bwd(*args, causal, q_offset)
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in (dq, dk, dv)] == [
        ((B, S, H, hd), torch.bfloat16, "meta"), ((B, T, K, hd), torch.bfloat16, "meta"),
        ((B, T, K, hd), torch.bfloat16, "meta")]
    # the five products of a flash backward over the live (query, key) pairs
    pairs = tfa.live_pairs(S, T, causal, q_offset)
    expect = 5 * 2 * B * H * hd * pairs
    assert expect == tfa.bwd_flops(B, S, T, H, hd, causal, q_offset) \
        == 5 * tfa.flops(B, S, T, H, hd, causal, q_offset) // 2
    assert counter.get_flop_counts()["Global"] == {torch.ops.repro_torch.k1_bwd: expect}


def test_k1_bwd_refuses_what_its_kernel_does_not_take():
    q, k, v, out, dout, lse = _meta_bwd_inputs(1, 16, 16, 4, 2, 64)
    f32 = [t.float() for t in (q, k, v, out, dout)]
    with pytest.raises(ValueError, match="bfloat16"):
        torch.ops.repro_torch.k1_bwd(*f32, lse, True, 0)
    wide = _meta_bwd_inputs(1, 16, 16, 4, 2, 256)
    with pytest.raises(ValueError, match="head_dim"):
        torch.ops.repro_torch.k1_bwd(*wide, True, 0)
    with pytest.raises(ValueError, match="log-sum-exp"):
        torch.ops.repro_torch.k1_bwd(q, k, v, out, dout, lse[:, :, :8], True, 0)
    with pytest.raises(ValueError, match="q_offset"):
        torch.ops.repro_torch.k1_bwd(q, k, v, out, dout, lse, True, 1)
    z = torch.zeros((1, 16, 4, 64), dtype=torch.bfloat16)   # no CPU implementation
    with pytest.raises(NotImplementedError, match="CPU"):
        torch.ops.repro_torch.k1_bwd(z, z[:, :, :2], z[:, :, :2], z, z, torch.zeros(1, 4, 16),
                                     True, 0)


class _OpLog(TorchDispatchMode):
    """The (operator, number of arguments) of every call under it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((str(func.overloadpacket), len(args) + len(kwargs or {})))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype,hd,kernel", [
    ("bfloat16", 32, True), ("bfloat16", 64, True), ("bfloat16", 128, True),
    ("bfloat16", 256, False), ("float32", 64, False), ("float32", 128, False)])
def test_flash_attention_fn_backward_dispatch_on_meta(dtype, hd, kernel):
    """bf16 at hd 32, 64, 128: the forward writes the log-sum-exp (k1_fwd's
    sixth argument) and the backward is k1_bwd; f32 and hd 256: the forward
    takes five arguments and the backward is ``ref.attention_bwd``'s tensor
    ops. No launch and no count on meta; without a gradient no LSE."""
    dt = getattr(torch, dtype)
    q = torch.empty((2, 40, 14, hd), dtype=dt, device="meta", requires_grad=True)
    k, v = (torch.empty((2, 40, 2, hd), dtype=dt, device="meta", requires_grad=True)
            for _ in "kv")
    counts = (ops.attention.launches, ops.attention.bwd_launches, ops.attention.bwd_plain)
    with _OpLog() as log:
        out = ops.attention(q, k, v, causal=True)
        forward = list(log.calls)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    names = [n for n, _ in log.calls]
    assert [(tuple(g.shape), g.dtype) for g in grads] == [
        (tuple(t.shape), dt) for t in (q, k, v)]
    assert ("repro_torch.k1_fwd", 6 if kernel else 5) in forward
    assert ("repro_torch.k1_bwd" in names) == kernel
    assert ("aten.bmm" in names) != kernel          # the plain backward's einsums
    assert names.count("repro_torch.k1_fwd") == 1
    assert (ops.attention.launches, ops.attention.bwd_launches,
            ops.attention.bwd_plain) == counts
    with _OpLog() as log:
        ops.attention(q.detach(), k.detach(), v.detach(), causal=True)
    assert ("repro_torch.k1_fwd", 5) in log.calls
    assert tfa.backward_kernel_takes(q) == kernel
