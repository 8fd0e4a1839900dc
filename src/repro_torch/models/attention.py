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

Under a mesh (``RunConfig.constrain`` from ``parallel.mesh``) q, k and v
are DTensors, constrained as the JAX package constrains them: with
``attn_shard="heads"`` each rank holds its q heads and the k/v heads
they read, with ``"seq"`` a block of query rows against the full k/v.
``_local_attention`` then runs the kernel on each rank's shards (the
ctypes launch sees plain tensors) and wraps the output back with q's
placements.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.kernels.ref import repeat_kv
from repro_torch.models.layers import RunConfig, apply_rope, dense_init, linear, matmul
from repro_torch.parallel.mesh import (from_local, grad_placements, local_offset,
                                       merge_heads, moved_placements, split_heads)

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


def decode_attention(q, k_cache, v_cache, index: int, psum=None, head_dim=None,
                     t0: int = 0, t_reduce=None):
    """Single-token decode, GQA-folded. q:(B,1,K,G,hd) caches:(B,T,K,hd).

    The scores are taken in f32 from the cache's values (the JAX package
    uses ``preferred_element_type=f32``, so bf16 x bf16 scores are never
    rounded to bf16). The port upcasts q and the K cache to f32 for this
    product: per layer and step that is an extra f32 copy of the K cache,
    4 * B*T*K*hd bytes written and read (2.4 MB for qwen2-0.5b at B=8,
    T=576), against 2 * B*T*K*hd bytes for reading the bf16 cache.
    ``psum`` sums the scores over the ranks that hold the other slices of
    head_dim, whose whole size ``head_dim`` then sets the scale
    (``_local_decode``). With ``t_reduce`` the caches hold this rank's
    slots from global slot ``t0`` of a cache cut over ranks along T:
    ``t_reduce(x, "max" | "sum")`` reduces over those ranks, and the
    softmax's max and sum and the output are taken over all the slots.
    """
    scale = 1.0 / math.sqrt(head_dim or q.shape[-1])
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k_cache.float()) * scale
    if psum is not None:
        scores = psum(scores)
    valid = torch.arange(k_cache.shape[1], device=q.device) + t0 <= index
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    if t_reduce is None:
        p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        return torch.einsum("bkgst,btkh->bskgh", p, v_cache)
    m = t_reduce(scores.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(scores - m)
    l = t_reduce(p.sum(dim=-1, keepdim=True), "sum")                # (B,K,G,1,1)
    o = t_reduce(torch.einsum("bkgst,btkh->bskgh", p.to(v_cache.dtype), v_cache).float(),
                 "sum")
    return (o / l.permute(0, 3, 1, 2, 4)).to(v_cache.dtype)


def _write_cache(cache: torch.Tensor, new: torch.Tensor, index: int) -> None:
    """Write ``new`` (B,1,K,hd) into ``cache`` (B,T,K,hd) at ``index``, in place.

    Like ``jax.lax.dynamic_update_slice_in_dim``, an out-of-range index
    is clamped into [0, T - 1], so the last slot is overwritten; nothing
    is ever indexed out of bounds. A DTensor cache is written in each
    rank's shard; one cut along T (the long-context case) only on the
    ranks whose slots hold ``index``.
    """
    start = min(max(index, 0), cache.shape[1] - new.shape[1])
    if isinstance(cache, DTensor):
        new = new.redistribute(cache.device_mesh, moved_placements(
            cache.placements, {0: 0, 2: 2, 3: 3}))
        t0 = local_offset(cache, 1)
        cache, new = cache.to_local(), new.to_local()
        start -= t0
        if not 0 <= start < cache.shape[1]:
            return                                  # the slot lives on another rank
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)


# a (B, T, K, hd) cache's sharded dim -> that dim of q (B, 1, H, hd) and of
# decode's output (B, 1, K, G, hd)
_CACHE_TO_Q = {0: 0, 2: 2, 3: 3}
_CACHE_TO_OUT = {0: 0, 2: 2, 3: 4}
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _local_decode(q, k_cache, v_cache, index: int):
    """``decode_attention`` on each rank's shard of a DTensor cache.

    q (B, 1, H, hd) is placed as the cache is (its batch, its KV heads'
    query heads, its slice of head_dim) and folded on each rank; where
    the cache shards head_dim the scores are summed over those ranks,
    and where it shards T (the long-context case) the softmax and the
    output are reduced over those ranks. The output (B, 1, K, G, hd)
    keeps the cache's placements but T's (replicated).
    """
    mesh = k_cache.device_mesh
    q_pl = moved_placements(k_cache.placements, _CACHE_TO_Q)
    out_pl = moved_placements(k_cache.placements, _CACHE_TO_OUT)
    hd_dims = [i for i, p in enumerate(k_cache.placements) if p == Shard(3)]
    t_dims = [i for i, p in enumerate(k_cache.placements) if p == Shard(1)]
    ql, kl, vl = q.redistribute(mesh, q_pl).to_local(), k_cache.to_local(), v_cache.to_local()

    def reduce(x, dims, op="sum"):
        x = x.clone()
        for i in dims:
            dist.all_reduce(x, op=_REDUCE_OPS[op], group=mesh.get_group(i))
        return x
    out = decode_attention(_gqa_fold(ql, kl.shape[2]), kl, vl, index,
                           psum=(lambda x: reduce(x, hd_dims)) if hd_dims else None,
                           head_dim=q.shape[-1], t0=local_offset(k_cache, 1),
                           t_reduce=(lambda x, op: reduce(x, t_dims, op)) if t_dims else None)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def _local_attention(q, k, v, *, causal: bool):
    """``ops.attention`` on this rank's shards of constrained q, k, v.

    Plain tensors go straight to ``ops.attention``. For DTensors: q's
    rows start at global row ``local_offset(q, 1)`` of the causal mask
    ("seq"); when q's heads are sharded and k/v are not (the rank's heads
    straddle a GQA group), k/v are broadcast with ``repeat_kv`` and
    sliced to those heads; else the rank's k/v heads are the ones its q
    heads read. The k/v gradient is Partial on each mesh dim where q is
    sharded and k/v are not: each rank's rows or heads add their share.
    """
    if not isinstance(q, DTensor):
        return ops.attention(q, k, v, causal=causal)
    grad = grad_placements(k, q)
    ql = q.to_local()
    kl, vl = k.to_local(grad_placements=grad), v.to_local(grad_placements=grad)
    H, Hl = q.shape[2], ql.shape[2]
    if Hl != H and kl.shape[2] == k.shape[2] and k.shape[2] != H:
        h0 = local_offset(q, 2)
        kl, vl = (repeat_kv(t, H)[:, :, h0:h0 + Hl] for t in (kl, vl))
    out = ops.attention(ql, kl, vl, causal=causal, q_offset=local_offset(q, 1))
    return from_local(out, q.device_mesh, q.placements, q.shape[:3] + v.shape[3:])


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

    q = matmul(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = split_heads(q, H, hd)

    if cross and cache is not None:
        # the cross k/v were computed at prefill and live in the cache
        k, v = cache
    else:
        k = matmul(src, params["wk"])
        v = matmul(src, params["wv"])
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        k = split_heads(k, K, hd)
        v = split_heads(v, K, hd)
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
        if isinstance(k_cache, DTensor):
            out = _local_decode(q, k_cache, v_cache, cache_index)
        else:
            out = decode_attention(_gqa_fold(q, K), k_cache, v_cache, cache_index)
    else:
        if return_kv or cache is not None:
            new_kv = (k, v)
        # 'heads': Megatron head-TP (needs H % tp == 0); the K-head k/v
        #          are sharded alike when K % tp == 0, else replicated.
        # 'seq':   query-sequence TP: each rank owns a q-row block against
        #          the full k/v (picked when H doesn't divide the TP axis).
        if rc.attn_shard == "seq":
            q_axes, kv_axes = ("dp", "tp", None, None), ("dp", None, None, None)
        else:
            q_axes = kv_axes = ("dp", None, "tp", None)
        q = rc.constrain(q, q_axes)
        k, v = rc.constrain(k, kv_axes), rc.constrain(v, kv_axes)
        # ---- K-head k/v straight into K1 on the card: no repeat_kv copy ----
        out = rc.constrain(_local_attention(q, k, v, causal=causal), q_axes)
    out = merge_heads(out)
    return linear(out, params["wo"]), new_kv
