"""Attention: GQA, dense + chunked(online-softmax) + decode-with-cache paths.

Shapes convention (as in the JAX package):
  q: (B, S, H, hd)    k/v: (B, T, K, hd)    H = K * G   (GQA groups)

Prefill hands the projected K-head k/v to ``kernels.ops.attention``,
i.e. kernel K1 on a CUDA tensor and its plain version on a CPU tensor;
both read KV head h // G for query head h, so no full-H copy of k/v is
made (the JAX package broadcasts with ``repeat_kv`` first). That one
call takes the place of both of the JAX package's branches
(``full_attention`` up to ``attn_dense_max``, ``chunked_attention``
beyond), which compute the same function.
``full_attention`` and ``chunked_attention`` are kept as the ports of
those two jnp paths. Self-attention decode keeps the (K, G) folded form
against the K-head cache and stays plain PyTorch: the JAX package
computes it outside any Pallas kernel too. Cross-attention (the VLM's
gated blocks over the image tokens) goes through ``ops.attention``
non-causal in prefill and in decode, where one query attends to the N
cached image keys.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import repeat_kv  # noqa: F401  (the reference's broadcast)
from repro_torch.models.layers import RunConfig, apply_rope, dense_init

NEG_INF = -1e30


def init_attention(gen, cfg, dtype, device, cross: bool = False):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, H * hd), dtype, device),
        "wk": dense_init(gen, (d, K * hd), dtype, device),
        "wv": dense_init(gen, (d, K * hd), dtype, device),
        "wo": dense_init(gen, (H * hd, d), dtype, device,
                         scale=1.0 / (2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((K * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((K * hd,), dtype=dtype, device=device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Dense attention in full-H form. q:(B,S,H,hd) k/v:(B,T,H,hd).

    The scores are computed in the input dtype and then upcast (so bf16
    scores are rounded to bf16 first), and the probabilities are cast to
    v's dtype before the second product, as in the JAX package.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if causal:
        S, T = scores.shape[-2], scores.shape[-1]
        qpos = torch.arange(S, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(T, device=q.device)[None, :]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


def chunked_attention(q, k, v, *, chunk: int, causal: bool = True):
    """Online-softmax attention, scanning KV in blocks of ``chunk``.

    Full-H form. Memory: O(S * chunk) scores live at once. The
    accumulator stays in v's dtype, as in the JAX package.
    """
    B, S, H, hd = q.shape
    T = k.shape[1]
    n_blocks = T // chunk
    if n_blocks * chunk != T:
        raise ValueError(f"chunk {chunk} does not divide T={T}")
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, hd), dtype=v.dtype, device=q.device)
    for j in range(n_blocks):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bshd,bchd->bhsc", q, kj).float() * scale
        if causal:
            kpos = j * chunk + torch.arange(chunk, device=q.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhsc,bchd->bshd", p.to(vj.dtype), vj)
        acc = acc * corr.transpose(1, 2)[..., None].to(acc.dtype) + pv
        m = m_new
    l = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (acc.float() / l).to(v.dtype)


def _gqa_fold(q, n_kv):
    """(B,S,H,hd) -> (B,S,K,G,hd)."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def decode_attention(q, k_cache, v_cache, index: int):
    """Single-token decode, GQA-folded. q:(B,1,K,G,hd) caches:(B,T,K,hd).

    The scores are taken in f32 from the cache's values (the JAX package
    uses ``preferred_element_type=f32``, so bf16 x bf16 scores are never
    rounded to bf16). The port upcasts q and the K cache to f32 for this
    product: per layer and step that is an extra f32 copy of the K cache,
    4 * B*T*K*hd bytes written and read (2.4 MB for qwen2-0.5b at B=8,
    T=576), against 2 * B*T*K*hd bytes for reading the bf16 cache.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k_cache.float()) * scale
    valid = torch.arange(k_cache.shape[1], device=q.device) <= index
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgst,btkh->bskgh", p, v_cache)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, index: int) -> None:
    """Write ``new`` (B,1,K,hd) into ``cache`` (B,T,K,hd) at ``index``, in place.

    Like ``jax.lax.dynamic_update_slice_in_dim``, an out-of-range index
    is clamped into [0, T - 1], so the last slot is overwritten; nothing
    is ever indexed out of bounds.
    """
    start = min(max(index, 0), cache.shape[1] - new.shape[1])
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)


def apply_attention(
    params,
    x: torch.Tensor,
    cfg,
    rc: RunConfig,
    positions: Optional[torch.Tensor],
    *,
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    return_kv: bool = False,
    is_cross: bool = False,
):
    """Self- or cross-attention. Returns (out, new_kv): new_kv is (k, v) or None.

    Self-attention decode (``cache`` given) writes this step's k/v into
    the cache tensors in place (the JAX package donates the cache) and
    returns them. Cross-attention (``kv_x`` (B, N, D), or ``is_cross``)
    projects k and v from ``kv_x``, or in decode takes them from
    ``cache`` as they are, and applies no RoPE to q or k; in prefill and
    in decode it runs the full non-causal attention of the queries over
    the N keys through ``ops.attention`` (K1 on the card), as the JAX
    package runs ``full_attention`` for both.
    """
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    cross = is_cross or kv_x is not None
    src = kv_x if cross else x

    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = _split_heads(q, H, hd)

    if cross and cache is not None:
        # the cross k/v were computed at prefill and live in the cache
        k, v = cache
    else:
        k = src @ params["wk"]
        v = src @ params["wv"]
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        k = _split_heads(k, K, hd)
        v = _split_heads(v, K, hd)
        if not cross:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    new_kv = None
    if cache is not None and not cross:
        # ---- decode: GQA-folded against the K-head cache ----
        k_cache, v_cache = cache
        _write_cache(k_cache, k, cache_index)
        _write_cache(v_cache, v, cache_index)
        new_kv = (k_cache, v_cache)
        out = decode_attention(_gqa_fold(q, K), k_cache, v_cache, cache_index)
    else:
        if return_kv or cache is not None:
            new_kv = (k, v)
        # ---- K-head k/v straight into K1 on the card: no repeat_kv copy ----
        out = ops.attention(q, k, v, causal=causal)
    out = out.reshape(out.shape[:2] + (H * hd,))
    return out @ params["wo"], new_kv
